"""The control: the reference in the program's place with fp8 products (the
precision below the configurations' bf16) comes out not correct under each
cell's limits, and reads further from the reference than the bf16 program
does. At tiny widths on the CPU; the same on the card at full size is
``calibrate.py``'s ``fp8`` side."""
import pytest
import torch

from portbench import check, harness, tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("name,accum", [("stablelm-1.6b.train-4k", 1),
                                        ("zamba2-1.2b.train-4k-b8", 1),
                                        ("stablelm-1.6b.train-4k", 2)])
def test_fp8_control_is_not_correct(name, accum):
    cell = tiny.cell(name, "bfloat16", accum=accum)
    s = harness.first_steps(cell, 2, CPU)
    ref = harness.reference_run(cell, s, 2, CPU)
    control = check.numbers(harness.reference_run(cell, s, 2, CPU, quant="fp8"), ref)
    program = check.numbers(s.got, ref)
    assert not check.verdict(control, cell.limits), control
    assert control["grad"] > 3 * program["grad"], (control, program)
