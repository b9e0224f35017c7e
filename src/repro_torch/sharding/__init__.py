from repro_torch.sharding.ctx import activation_specs, constrain
from repro_torch.sharding.specs import (batch_specs, data_axes, named,
                                        opt_state_specs, param_specs)

__all__ = ["activation_specs", "constrain", "batch_specs", "data_axes",
           "named", "opt_state_specs", "param_specs"]
