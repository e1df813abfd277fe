"""COULER core: unified workflow interface, IR, and the paper's optimizers."""
from repro_torch.core import api as couler
from repro_torch.core.ir import Condition, Job, Resources, WorkflowIR
