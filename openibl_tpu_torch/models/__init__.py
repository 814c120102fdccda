"""Model factory with the JAX package's registry names, and the port's
own ``anyloc_dinov2_vitg14`` (AnyLoc-VLAD on DINOv2 ViT-g/14, which the JAX
package does not have)."""

from openibl_tpu_torch.models.anyloc import AnyLocVLAD
from openibl_tpu_torch.models.vgg import VGG16
from openibl_tpu_torch.models.netvlad import (
    NetVLAD,
    EmbedNet,
    EmbedNetPCA,
    EmbedRegionNet,
    netvlad_apply,
    region_vlads,
    netvlad_init_from_clusters,
    vlad_postprocess,
)

__factory = {
    "vgg16": VGG16,
    "netvlad": NetVLAD,
    "embednet": EmbedNet,
    "embednetpca": EmbedNetPCA,
    "embedregionnet": EmbedRegionNet,
    "anyloc_dinov2_vitg14": AnyLocVLAD,
}


def names():
    return sorted(__factory.keys())


def create(name, *args, **kwargs):
    """Create a model (an ``nn.Module`` holding its parameters) by name."""
    if name not in __factory:
        raise KeyError(f"Unknown model: {name}")
    return __factory[name](*args, **kwargs)
