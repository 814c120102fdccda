"""Dataset registry with the JAX package's names (port of
openibl_tpu/data/__init__.py)."""


def names():
    return ["pitts", "tokyo", "demo", "synthetic"]


def create(name, root, *args, **kwargs):
    if name == "pitts":
        from openibl_tpu_torch.data.pitts import Pittsburgh

        return Pittsburgh(root, *args, **kwargs)
    if name == "tokyo":
        from openibl_tpu_torch.data.tokyo import Tokyo

        return Tokyo(root, *args, **kwargs)
    if name == "demo":
        from openibl_tpu_torch.data.demo import Demo

        return Demo(root, *args, **kwargs)
    if name == "synthetic":
        from openibl_tpu_torch.data.synthetic import SyntheticDataset

        return SyntheticDataset(root, *args, **kwargs)
    raise KeyError(f"Unknown dataset: {name}")
