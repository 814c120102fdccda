"""IO helpers with the API of openibl_tpu/utils/serialization.py: JSON,
MATLAB dbStructs, checkpoints and a tolerant state-dict copy, on the port's
own modules (the checkpoint format lives in utils/checkpoint.py)."""

from openibl_tpu_torch.data.dataset import read_json, write_json  # noqa: F401
from openibl_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_checkpoint,
    load_metadata,
    save_checkpoint,
)


def copy_state_dict(state_dict, model, verbose=True):
    """Copy each entry of ``state_dict`` whose key and shape match one of
    ``model``'s into the model, in place; the model keeps its own value for
    the rest (the tolerant copy of the JAX package's ``merge_params``).
    Returns the keys of ``state_dict`` it skipped, printed when
    ``verbose``."""
    own = model.state_dict()
    fits, skipped = {}, []
    for key, value in state_dict.items():
        if key in own and tuple(value.shape) == tuple(own[key].shape):
            fits[key] = value
        else:
            skipped.append(key)
            if verbose:
                got = tuple(own[key].shape) if key in own else "absent"
                print(f"skipped {key}: {tuple(value.shape)} vs {got}")
    model.load_state_dict(fits, strict=False)
    return skipped


def read_mat(path, key="dbStruct"):
    """Load a MATLAB struct array entry (NetVLAD dbStruct files)."""
    from openibl_tpu_torch.data.pitts import read_mat_struct

    return read_mat_struct(path, key)
