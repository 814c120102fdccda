"""What the drivers share: the run's context and outcome, handing the
benchmark's weights to the port, and freeing the port's state before the
reference runs."""

import dataclasses
import gc
import statistics
import time

import torch

# the benchmark's weight names → the port's parameter names
PORT_NAMES = {"assign_w": "net_vlad.assign_w",
              "centroids": "net_vlad.centroids",
              "pca_w": "pca_layer.w", "pca_b": "pca_layer.b"}


def now():
    return time.perf_counter()


@dataclasses.dataclass
class Context:
    """One run: the cell's configuration and mix (dicts of the JSON
    files), the run's arguments, the device, the process's start on the
    harness clock, the tracer of the window, and the seconds of each
    step of set-up (``mark``)."""
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    tracer: object = None
    setup_steps: dict = dataclasses.field(default_factory=dict)

    def mark(self, step):
        """Close the set-up step ``step``: the time since the previous
        mark (the process's start for the first) is that step's."""
        t = now()
        last = self.t_start + sum(self.setup_steps.values())
        self.setup_steps[step] = t - last


@dataclasses.dataclass
class Outcome:
    """What a driver hands back. ``values``: the end-to-end metrics it
    measured; ``checks``: {name: number compared}; ``info``: what the
    per-layer readers read (requests, spans, counters, step FLOPs)."""
    attempted: int
    failed: int
    values: dict
    checks: dict
    memory_peak_bytes: int
    trace: object = None
    info: dict = dataclasses.field(default_factory=dict)


def port_name(name):
    if name in PORT_NAMES:
        return PORT_NAMES[name]
    return f"base.{name}"


@torch.no_grad()
def load_into(model, weights):
    """Copy the benchmark's ``weights`` into ``model``'s parameters (those
    the model has), keeping each parameter's layout; every parameter of
    the model must be given, at its shape."""
    params = dict(model.named_parameters())
    given = {port_name(n): v for n, v in weights.items()}
    for name, target in params.items():
        value = given.get(name)
        if value is None or tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"the benchmark's weights do not fit the port's "
                             f"{name} {tuple(target.shape)}")
        target.copy_(value)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device):
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device):
    """Drop what nobody holds any more, on the host and on the card."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def leaf_gaps(prog, ref):
    """{leaf: the gap between the port's norm and the reference's, over
    max(the reference's norm of that leaf, the median leaf's norm)}.
    ``prog`` and ``ref``: {leaf: tensor}, the same leaves."""
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in ref}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in ref}
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in ref}
