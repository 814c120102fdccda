"""Typed configuration objects (port of openibl_tpu/config.py).

Plain dataclasses with the JAX package's fields and defaults. Canonical
values are the published recipe. ``TrainConfig`` drives
``engine.pipeline.run_baseline_training``, ``SFRSConfig``
``engine.pipeline.run_sfrs_training`` and ``EvalConfig``
``engine.pipeline.run_eval``.
"""

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class DataConfig:
    dataset: str = "pitts"
    scale: Optional[str] = "30k"
    data_dir: str = "data"
    height: int = 480
    width: int = 640
    test_batch_size: int = 32
    workers: int = 2  # prefetch depth


@dataclasses.dataclass
class TrainConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    arch: str = "vgg16"
    train_layers: str = "conv5"
    num_clusters: int = 64
    loss_type: str = "triplet"  # triplet | sare_ind | sare_joint
    use_vlad: bool = True  # False trains on the global max-pool feature
    margin_sq: float = 0.1  # margin = sqrt(margin_sq)
    tuple_size: int = 1  # tuples per train step
    neg_num: int = 10
    neg_pool: int = 1000
    cache_size: int = 1000
    iters: int = 0  # >0 caps train iterations per subset (reference --iters)
    epochs: int = 5
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 1e-3
    step_size: int = 5
    gamma: float = 0.5
    eval_step: int = 1
    seed: int = 43
    pca_dim: int = 4096
    whiten: bool = True  # PCA whitening at the final test (reference --nowhiten)
    logs_dir: str = "logs"
    init_dir: str = "logs"
    resume: str = ""
    print_freq: int = 10
    compute_dtype: str = "float32"  # or "bfloat16"
    remat: bool = False  # recompute backbone activations in the backward
    device_jitter: bool = False  # ColorJitter on the device (ops/augment.py)
    augment: bool = True  # False disables ColorJitter (deterministic pixels)

    @property
    def margin(self):
        return self.margin_sq ** 0.5


@dataclasses.dataclass
class SFRSConfig(TrainConfig):
    loss_type: str = "sare_ind"
    generations: int = 4
    temperature: Tuple[float, ...] = (0.07, 0.07, 0.06, 0.05)
    soft_weight: float = 0.5
    pos_num: int = 10
    pos_pool: int = 20
    epochs: int = 5
    rerank_lambda: float = 0.1


@dataclasses.dataclass
class EvalConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    checkpoint: str = ""
    pca_params: str = ""
    reduction: bool = True  # apply PCA-whitening to pca_dim
    whiten: bool = True  # whitening inside the reduction (reference --nowhiten)
    use_vlad: bool = True  # False evaluates the global max-pool feature
    pca_dim: int = 4096
    rerank: bool = False  # k-reciprocal rerank (k1 = rr_topk, k2 = 1)
    rr_topk: int = 25
    lambda_value: float = 0.0
    nms: bool = False  # Tokyo spatial NMS
    num_clusters: int = 64
    arch: str = "vgg16"
    compute_dtype: str = "float32"  # or "bfloat16": match the training dtype
    # dataset whose train split fits an on-demand PCA ('' = pitts for
    # pitts/tokyo evals, as the reference's test.py; else the same dataset)
    pca_dataset: str = ""
    pca_scale: str = ""
