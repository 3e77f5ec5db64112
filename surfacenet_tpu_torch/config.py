"""Typed configuration tree (own copy of ``surfacenet_tpu/config.py``).

Same fields, defaults, JSON format and presets as the JAX package, so the
files under ``configs/`` load into either package and give equal trees.
The field comments here are short; the JAX package's config module keeps
the measurements behind each default.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VoxelConfig:
    """Scene discretization: voxel size `s`, cube side D, cube overlap."""

    voxel_size_mm: float = 0.4
    cube_size: int = 32
    overlap: int = 8
    center_colors: bool = True  # mean-centre each CVC before the net

    @property
    def stride(self) -> int:
        """Cube-to-cube stride in voxels along each axis."""
        return self.cube_size - self.overlap

    @property
    def cube_extent_mm(self) -> float:
        return self.voxel_size_mm * self.cube_size


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """SurfaceNet 3D-CNN architecture."""

    block_channels: Tuple[int, ...] = (32, 80, 160, 300)
    convs_per_block: Tuple[int, ...] = (3, 3, 3, 3)
    dilations: Tuple[int, ...] = (1, 1, 1, 2)
    pool_after_block: Tuple[bool, ...] = (True, True, False, False)
    side_channels: int = 16
    in_channels: int = 6  # CVC pair: 2 x RGB
    use_batchnorm: bool = True
    dtype: str = "bfloat16"  # compute dtype (weights are kept in float32)
    upsample_mode: str = "resize"  # side layers: "resize" | "deconv"
    # inference through models.surfacenet.fused_infer_apply: BatchNorm
    # folded into each conv, every 3^3 conv through the implicit-GEMM conv
    # kernel on the card (its plain version on the CPU); resize side
    # layers only.  Off in every preset, as in the reference.
    fused_inference: bool = False

    @staticmethod
    def mxu_aligned() -> "ModelConfig":
        return ModelConfig(
            block_channels=(128, 128, 256, 256),
            convs_per_block=(2, 2, 2, 2),
            side_channels=16,
        )

    @staticmethod
    def fast() -> "ModelConfig":
        return ModelConfig(
            block_channels=(128, 128, 128, 256),
            convs_per_block=(1, 2, 2, 2),
            side_channels=16,
        )

    @staticmethod
    def fast64() -> "ModelConfig":
        """The 64^3 apply-point widths of the ``dtu9_full`` preset."""
        return ModelConfig(
            block_channels=(32, 128, 128, 256),
            convs_per_block=(1, 2, 2, 2),
            side_channels=16,
        )

    @staticmethod
    def tiny() -> "ModelConfig":
        """Small config for tests / CPU (same topology)."""
        return ModelConfig(
            block_channels=(8, 12, 16, 16),
            convs_per_block=(1, 1, 1, 1),
            side_channels=4,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class PairNetConfig:
    patch_size: int = 32
    channels: Tuple[int, ...] = (32, 64, 128)
    embed_dim: int = 64
    margin: float = 0.5
    n_geom_features: int = 2


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """View-pair fusion, binarization and ray-pooling thinning."""

    n_view_pairs: int = 5
    tau: float = 0.7  # binarization threshold on fused probability
    gamma: float = 0.8  # ray-pooling vote fraction
    adaptive_threshold: bool = False
    adaptive_taus: Tuple[float, ...] = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
    adaptive_target_density: float = 0.02
    # "exact" | "affine" | "affine_pallas" | "affine_matmul"; the port runs
    # the affine vote (its CUDA kernel) for "affine" and "affine_pallas".
    ray_pool_mode: str = "exact"
    fusion_mode: str = "mean"  # "mean" | "consensus"
    pair_dist_sigma_frac: float = 0.0
    consensus_beta: float = 8.0
    consensus_deadband: float = 0.3
    n_pool_views: int = 6
    pool_window_vox: int = -1  # -1 = auto: min(2, overlap // 2)
    min_component: int = 0


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Scene sweep / batched cube scheduler."""

    cube_batch: int = 16
    prefilter: bool = True
    min_views_visible: int = 2
    # True: the gather samples images of ``gather_dtype``; False: float32.
    use_pallas_gather: bool = False
    compact_k: int = 0  # <= 0: auto, max(4096, 4 * D^2)
    gather_dtype: str = "bfloat16"
    gather_chunk_windows: bool = True  # TPU tiling knob; unused by the port
    refine_calib: bool = False
    refine_calib_steps: int = 80
    refine_calib_probes: int = 2048


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    block_axis: int = 1
    cube_axis: int = -1
    axis_names: Tuple[str, ...] = ("block", "cube")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 1e-4
    n_steps: int = 10000
    class_balance: bool = True
    scan_chunk: int = 25
    lr_decay: str = "none"
    checkpoint_every: int = 500
    checkpoint_dir: str = "checkpoints"
    seed: int = 0
    pool_size: int = 2048
    pool_refresh_steps: int = 0
    eval_every: int = 0
    aug_calib_sigma_px: float = 0.0
    aug_calib_anneal_steps: int = 0


@dataclasses.dataclass(frozen=True)
class Config:
    voxel: VoxelConfig = VoxelConfig()
    model: ModelConfig = ModelConfig()
    pairnet: PairNetConfig = PairNetConfig()
    fusion: FusionConfig = FusionConfig()
    sweep: SweepConfig = SweepConfig()
    mesh: MeshConfig = MeshConfig()
    train: TrainConfig = TrainConfig()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        raw = json.loads(s)

        def _mk(cls, d):
            names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in d.items() if k in names
            })

        return Config(
            voxel=_mk(VoxelConfig, raw.get("voxel", {})),
            model=_mk(ModelConfig, raw.get("model", {})),
            pairnet=_mk(PairNetConfig, raw.get("pairnet", {})),
            fusion=_mk(FusionConfig, raw.get("fusion", {})),
            sweep=_mk(SweepConfig, raw.get("sweep", {})),
            mesh=_mk(MeshConfig, raw.get("mesh", {})),
            train=_mk(TrainConfig, raw.get("train", {})),
        )


def baseline_config(name: str) -> Config:
    """The named operating points of the JAX package's ``baseline_config``."""
    base = Config()
    base = base.replace(
        sweep=dataclasses.replace(
            base.sweep, use_pallas_gather=True, refine_calib=True
        ),
        fusion=dataclasses.replace(
            base.fusion, ray_pool_mode="affine_pallas"
        ),
    )
    b32 = dataclasses.replace(base.sweep, cube_batch=32)
    b64 = dataclasses.replace(base.sweep, cube_batch=24)
    if name == "dtu9_single":
        return base.replace(
            voxel=dataclasses.replace(base.voxel, cube_size=32),
            fusion=dataclasses.replace(
                base.fusion, n_view_pairs=1, adaptive_threshold=False
            ),
            sweep=b32,
        )
    if name == "dtu9_full":
        return base.replace(
            voxel=dataclasses.replace(base.voxel, cube_size=64),
            model=ModelConfig.fast64(),
            fusion=dataclasses.replace(
                base.fusion, n_view_pairs=5, adaptive_threshold=False
            ),
            sweep=b64,
        )
    if name == "dtu9_paper":
        return base.replace(
            voxel=dataclasses.replace(base.voxel, cube_size=64),
            fusion=dataclasses.replace(
                base.fusion, n_view_pairs=5, adaptive_threshold=False
            ),
            sweep=b64,
        )
    if name == "dtu_eval_split":
        return base.replace(
            voxel=dataclasses.replace(base.voxel, cube_size=64),
            sweep=b64,
        )
    if name == "highres_sharded":
        return base.replace(
            voxel=dataclasses.replace(
                base.voxel, voxel_size_mm=0.2, cube_size=64
            ),
            mesh=dataclasses.replace(base.mesh, block_axis=2),
            sweep=b64,
        )
    if name == "tanks_temples":
        return base.replace(
            voxel=dataclasses.replace(
                base.voxel, voxel_size_mm=2.0, cube_size=64
            ),
            sweep=b64,
        )
    if name == "golden_aligned":
        c = baseline_config("dtu9_single")
        return c.replace(
            voxel=dataclasses.replace(c.voxel, voxel_size_mm=0.5),
            model=ModelConfig.mxu_aligned(),
            fusion=dataclasses.replace(c.fusion, n_view_pairs=5),
            train=dataclasses.replace(
                c.train, n_steps=30000, lr=3e-3, lr_decay="cosine",
                batch_size=16,
            ),
        )
    if name == "golden_fast":
        c = baseline_config("golden_aligned")
        return c.replace(model=ModelConfig.fast())
    raise ValueError(f"unknown baseline config: {name}")
