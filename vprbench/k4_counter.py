"""K4's launch counter for kernels/K4.json: ``.launches`` of the port's
``openibl_tpu_torch.ops.conv_kernel.conv3x3_f32``, read at each call, or 0
in a checkout of the port that has no K4 (the harness imports every
kernel's counter at start, and a checkout from before K4 must still run).
With no launches, ``k4_roofline.build`` reads nothing and is left out."""

import importlib


class _Launches:
    @property
    def launches(self):
        try:
            module = importlib.import_module(
                "openibl_tpu_torch.ops.conv_kernel")
        except ImportError:
            return 0
        return module.conv3x3_f32.launches


conv3x3_f32 = _Launches()
