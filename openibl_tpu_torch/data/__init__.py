"""Dataset registry with the JAX package's names (port of
openibl_tpu/data/__init__.py). ``tokyo`` and ``demo`` come with the masked
Tokyo 24/7 evaluation (ROADMAP Queue 1 item 8)."""


def names():
    return ["pitts", "tokyo", "demo", "synthetic"]


def create(name, root, *args, **kwargs):
    if name == "pitts":
        from openibl_tpu_torch.data.pitts import Pittsburgh

        return Pittsburgh(root, *args, **kwargs)
    if name in ("tokyo", "demo"):
        raise NotImplementedError(
            f"the {name!r} dataset is not ported to openibl_tpu_torch yet: "
            f"ROADMAP Queue 1 item 8 (masked Tokyo 24/7 evaluation)")
    if name == "synthetic":
        from openibl_tpu_torch.data.synthetic import SyntheticDataset

        return SyntheticDataset(root, *args, **kwargs)
    raise KeyError(f"Unknown dataset: {name}")
