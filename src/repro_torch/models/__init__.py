from repro_torch.models.transformer import (apply_lm, apply_lm_decode,
                                            init_caches, init_lm)
