"""Model factory with the JAX package's registry names.

``embedregionnet`` comes with the SFRS slice (ROADMAP Queue 1 item 10).
"""

from openibl_tpu_torch.models.vgg import VGG16
from openibl_tpu_torch.models.netvlad import (
    NetVLAD,
    EmbedNet,
    EmbedNetPCA,
    netvlad_apply,
    netvlad_init_from_clusters,
    vlad_postprocess,
)

__factory = {
    "vgg16": VGG16,
    "netvlad": NetVLAD,
    "embednet": EmbedNet,
    "embednetpca": EmbedNetPCA,
}


def names():
    return sorted(__factory.keys())


def create(name, *args, **kwargs):
    """Create a model (an ``nn.Module`` holding its parameters) by name."""
    if name not in __factory:
        raise KeyError(f"Unknown model: {name}")
    return __factory[name](*args, **kwargs)
