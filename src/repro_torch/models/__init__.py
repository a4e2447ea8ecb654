"""The LM substrate's models: the dense decoder and ssm families so far."""
from repro_torch.models import model
from repro_torch.models.model import (decode_step, forward, init_cache,
                                      init_params, param_count, prefill)

__all__ = ["model", "init_params", "forward", "prefill", "decode_step",
           "init_cache", "param_count"]
