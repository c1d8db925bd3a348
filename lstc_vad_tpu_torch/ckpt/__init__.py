from .interop import (load_reference_checkpoint,  # noqa: F401
                      state_dict_from_jax)
