from .interop import (load_reference_checkpoint,  # noqa: F401
                      state_dict_from_jax)
from .io import (load_checkpoint, save_checkpoint,  # noqa: F401
                 wait_for_saves)
