from repro_torch.roofline.analysis import (RooflineTerms, count_step, measured_report,
                                           roofline_report)
