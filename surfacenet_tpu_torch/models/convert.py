"""SurfaceNet and pair-net weights between the JAX (flax) layout and this
port.

``params_from_jax`` maps the reference's variables, given as nested dicts
of numpy arrays (``{"params": ..., "batch_stats": ...}``), to a
``state_dict`` of ``models.surfacenet.SurfaceNet``:

  * ``Conv`` kernels go from DHWIO to OIDHW;
  * ``ConvTranspose`` kernels (deconv side layers) go from DHWIO to
    torch's (in, out, D, H, W) with every spatial axis flipped: flax's
    transposed conv correlates the stride-dilated input with the kernel as
    stored, torch's convolves with it;
  * ``BatchNorm`` scale/bias/mean/var become weight/bias/running_mean/
    running_var (the epsilon is flax's default, ``surfacenet.BN_EPS``).

``save_npz``/``load_npz`` store a state dict as one ``.npz`` file, the
format ``cli reconstruct --checkpoint`` reads.  Reading the reference's
Orbax checkpoints needs the JAX stack, so the conversion runs where JAX is
installed: load with ``surfacenet_tpu.train.train_surface.load_pretrained``,
map the leaves to numpy, then ``save_npz(params_from_jax(v), path)``.
``weights_torch/golden_{sphere,tori}_fast64_30k.npz`` (16,460,382 bytes
each: 4,110,337 float32 values and 11 BatchNorm step counters) are the
reference's ``weights/golden_{sphere,tori}_fast64_30k`` converted so::

    cfg = Config(model=ModelConfig.fast64())  # surfacenet_tpu.config
    # parameters do not depend on D: restore into an 8^3 template
    cfg = cfg.replace(voxel=dataclasses.replace(cfg.voxel, cube_size=8))
    _, v = load_pretrained("weights/golden_sphere_fast64_30k", cfg)
    v = jax.tree_util.tree_map(np.asarray, v)
    save_npz(params_from_jax(v),
             "weights_torch/golden_sphere_fast64_30k.npz")

and load with ``load_surfacenet(path, ModelConfig.fast64())`` (the
``dtu9_full`` preset's widths).  ``weights_torch/golden_{sphere,tori}_
30k.npz`` (33,529,682 bytes each: 8,375,537 float32 values and 16
BatchNorm step counters) are the paper-width ``weights/golden_{sphere,
tori}_30k`` converted the same way from a paper-width template::

    cfg = Config(model=ModelConfig())  # = configs/dtu9_paper.json's model
    cfg = cfg.replace(voxel=dataclasses.replace(cfg.voxel, cube_size=8))
    _, v = load_pretrained("weights/golden_sphere_30k", cfg)
    v = jax.tree_util.tree_map(np.asarray, v)
    save_npz(params_from_jax(v), "weights_torch/golden_sphere_30k.npz")

and load with ``load_surfacenet(path, ModelConfig())`` (the widths of
``dtu9_paper``, ``dtu9_single``, ``dtu_eval_split``, ``highres_sharded``
and ``tanks_temples``).  ``weights_torch/golden_multi_30k.npz`` (33,529,682
bytes, the same 8,375,537 values and 16 counters) is ``weights/
golden_multi_30k``, the one paper-width net that the eval split shares over
both golden scenes, converted by the same recipe; ``cli reconstruct-all
--checkpoint weights_torch/golden_multi_30k.npz`` runs the split with it
(``scripts/split_eval_demo.py``'s flags, ``Config()`` otherwise).

``pairnet_params_from_jax`` does the same for the pair net
(``models/pairnet.py``): ``Conv`` kernels from HWIO to OIHW, not flipped
(both frameworks correlate), and the ``Dense`` kernel transposed; its rows
stay in the reference's (H, W, C) flatten order, which ``PairNet`` keeps.
``weights_torch/pairnet_10000.npz`` and ``weights_torch/pairnet_1500.npz``
(899,614 bytes each: 224,384 float32 values) are the shipped
``weights/pairnet_10000`` and ``weights/pairnet_1500`` converted so::

    _, v = restore_pairnet("weights/pairnet_1500", Config())
    # surfacenet_tpu.train.train_pair, the default Config()
    v = jax.tree_util.tree_map(np.asarray, v)
    save_npz(pairnet_params_from_jax(v), "weights_torch/pairnet_1500.npz")

and load with ``train.train_pair.restore_pairnet(path, PairNetConfig())``
(``cli reconstruct --pairnet path``).  ``results/occlusion_r05.json``
compares the two nets (``learned_local/pairnet_1500`` and ``_10k``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from surfacenet_tpu_torch.config import ModelConfig
from surfacenet_tpu_torch.models.surfacenet import SurfaceNet


def _conv(k) -> torch.Tensor:  # (kd, kh, kw, in, out) -> (out, in, kd, kh, kw)
    return torch.from_numpy(
        np.transpose(np.asarray(k, np.float32), (4, 3, 0, 1, 2)).copy()
    )


def _deconv(k) -> torch.Tensor:  # -> (in, out, kd, kh, kw), flipped
    k = np.asarray(k, np.float32)[::-1, ::-1, ::-1]
    return torch.from_numpy(np.transpose(k, (3, 4, 0, 1, 2)).copy())


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _bn(out: dict, prefix: str, p: dict, st: dict) -> None:
    out[prefix + "weight"] = _t(p["scale"])
    out[prefix + "bias"] = _t(p["bias"])
    out[prefix + "running_mean"] = _t(st["mean"])
    out[prefix + "running_var"] = _t(st["var"])
    out[prefix + "num_batches_tracked"] = torch.tensor(0)


def _conv_into(out: dict, prefix: str, p: dict) -> None:
    out[prefix + "weight"] = _conv(p["kernel"])
    if "bias" in p:
        out[prefix + "bias"] = _t(p["bias"])


def params_from_jax(variables: dict) -> Dict[str, torch.Tensor]:
    """flax SurfaceNet variables (numpy leaves) -> port ``state_dict``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    n_blocks = sum(1 for k in params if k.startswith("ConvBlock_"))
    for b in range(n_blocks):
        bp = params[f"ConvBlock_{b}"]
        bs = stats.get(f"ConvBlock_{b}", {})
        n_convs = sum(1 for k in bp if k.startswith("Conv_"))
        for i in range(n_convs):
            _conv_into(out, f"blocks.{b}.convs.{i}.", bp[f"Conv_{i}"])
            if f"BatchNorm_{i}" in bp:
                _bn(out, f"blocks.{b}.bns.{i}.", bp[f"BatchNorm_{i}"],
                    bs[f"BatchNorm_{i}"])
        sp = params[f"SideLayer_{b}"]
        ss = stats.get(f"SideLayer_{b}", {})
        _conv_into(out, f"sides.{b}.conv.", sp["Conv_0"])
        if "BatchNorm_0" in sp:
            _bn(out, f"sides.{b}.bn.", sp["BatchNorm_0"], ss["BatchNorm_0"])
        if "ConvTranspose_0" in sp:
            ct = sp["ConvTranspose_0"]
            out[f"sides.{b}.deconv.weight"] = _deconv(ct["kernel"])
            out[f"sides.{b}.deconv.bias"] = _t(ct["bias"])
    _conv_into(out, "head.", params["Conv_0"])
    return out


def pairnet_params_from_jax(variables: dict) -> Dict[str, torch.Tensor]:
    """flax PairNet variables (numpy leaves) -> ``PairNet`` ``state_dict``."""
    params = variables["params"]
    out: Dict[str, torch.Tensor] = {}
    n_convs = sum(1 for k in params if k.startswith("Conv_"))
    for i in range(n_convs):
        p = params[f"Conv_{i}"]
        k = np.asarray(p["kernel"], np.float32)  # (kh, kw, in, out)
        out[f"convs.{i}.weight"] = torch.from_numpy(
            np.transpose(k, (3, 2, 0, 1)).copy())
        out[f"convs.{i}.bias"] = _t(p["bias"])
    d = params["Dense_0"]
    out["dense.weight"] = torch.from_numpy(
        np.asarray(d["kernel"], np.float32).T.copy())
    out["dense.bias"] = _t(d["bias"])
    return out


def save_npz(state_dict: Dict[str, torch.Tensor], path: str) -> None:
    np.savez(path, **{
        k: v.detach().cpu().numpy() for k, v in state_dict.items()
    })


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k].copy()) for k in z.files}


def load_surfacenet(path: str, cfg: ModelConfig) -> SurfaceNet:
    """A float32 SurfaceNet (eval mode, CPU) with weights from ``path``."""
    model = SurfaceNet(cfg)
    model.load_state_dict(load_npz(path))
    return model.eval()
