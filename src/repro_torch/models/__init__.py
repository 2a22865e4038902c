"""Model zoo: the 10 assigned architectures as one composable stack (twin
of the JAX package's ``models``, with its exports, plus ``from_numpy``,
which carries the reference's params across)."""
from .model import (decode_step, forward, from_numpy, init_decode_state,
                    input_specs, layer_kinds, lm_loss, make_abstract_params,
                    make_params, param_specs, period_of, prefill)
from .modules import (ParamSpec, abstract_params, count_params, init_params,
                      logical_axes_tree)
