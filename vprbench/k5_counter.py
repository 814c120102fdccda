"""K5's launch counter for kernels/K5.json: ``.launches`` of the port's
``openibl_tpu_torch.ops.linear_kernel.linear_f32``, read at each call, or 0
in a checkout of the port that has no K5 (the harness imports every
kernel's counter at start, and a checkout from before K5 must still run).
With no launches, ``k5_roofline.anyloc`` reads nothing and is left out."""

import importlib


class _Launches:
    @property
    def launches(self):
        try:
            module = importlib.import_module(
                "openibl_tpu_torch.ops.linear_kernel")
        except ImportError:
            return 0
        return module.linear_f32.launches


linear_f32 = _Launches()
