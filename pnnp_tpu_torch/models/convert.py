"""torch <-> JAX checkpoint conversion for the denoiser family and the flows.

NumPy copies of ``pnnp_tpu/models/convert.py``'s name/layout mapping
(``torch_state_to_flax`` :31, ``flax_to_torch_state`` :102) plus the weight
bridge :func:`params_from_jax`, which turns a JAX parameter tree (as numpy
arrays) into this package's ``state_dict``:

  * Conv2d        weight [O, I, kh, kw] <-> kernel [kh, kw, I, O]
  * ConvTranspose weight [I, O, kh, kw] <-> kernel [kh, kw, I, O], spatially
    flipped (``[::-1, ::-1]``): flax applies the transposed-conv kernel
    flipped, torch does not
  * biases map 1:1

:func:`eld_checkpoint_state_dict` reads the reference's ELD checkpoints and
:func:`load_tolerant` merges a checkpoint forgivingly, over state dicts.
"""

from __future__ import annotations

import warnings
from typing import Any, Mapping

import numpy as np
import torch


def _set_nested(tree: dict, path: list[str], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def torch_state_to_flax(
    state_dict: Mapping[str, Any],
    transpose_names: tuple[str, ...] = ("upv", "up", "deconv"),
) -> dict:
    """Convert a torch ``state_dict`` (tensors or ndarrays) to a flax param tree.

    Keys like ``conv1_1.weight`` become ``{'conv1_1': {'kernel': ...}}``;
    a ``module.`` prefix (DataParallel) is stripped, mirroring the reference's
    unwrap (trainer_SID.py:133). Submodule paths with dots nest naturally
    (``conv1.conv1.weight`` -> conv1/conv1/kernel for residual blocks).
    """
    params, stats = _torch_state_to_flax_full(state_dict, transpose_names)
    if stats:
        warnings.warn("checkpoint carries BatchNorm running stats; use "
                      "torch_state_to_flax_full to restore batch_stats")
    return params


def torch_state_to_flax_full(
    state_dict: Mapping[str, Any],
    transpose_names: tuple[str, ...] = ("upv", "up", "deconv"),
) -> tuple[dict, dict]:
    """Like :func:`torch_state_to_flax` but also returns the ``batch_stats``
    collection (BatchNorm running mean/var)."""
    return _torch_state_to_flax_full(state_dict, transpose_names)


def _torch_state_to_flax_full(state_dict, transpose_names):
    params: dict = {}
    stats: dict = {}
    for key, val in state_dict.items():
        arr = np.asarray(val.detach().cpu().numpy() if hasattr(val, "detach") else val)
        if key.startswith("module."):
            key = key[len("module."):]
        *path, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        if leaf == "running_mean":
            _set_nested(stats, path + ["mean"], arr)
            continue
        if leaf == "running_var":
            _set_nested(stats, path + ["var"], arr)
            continue
        if leaf == "bias":
            _set_nested(params, path + ["bias"], arr)
            continue
        if leaf != "weight":
            warnings.warn(f"skipping unrecognized state_dict leaf {key}")
            continue
        if arr.ndim == 4:
            # prefix match on the module name: substring matching would
            # catch unrelated modules that merely contain 'up'
            if any(path[-1].startswith(t) for t in transpose_names):
                # torch ConvTranspose2d applies the kernel unflipped; flax
                # ConvTranspose (lax.conv_transpose) applies it spatially
                # flipped — so flip kh/kw in the mapping.
                arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]  # [I,O,kh,kw] -> [kh,kw,I,O]
            else:
                arr = arr.transpose(2, 3, 1, 0)  # [O,I,kh,kw] -> [kh,kw,I,O]
            _set_nested(params, path + ["kernel"], arr)
        elif arr.ndim == 2:
            # torch Linear [out, in] -> flax Dense kernel [in, out]
            _set_nested(params, path + ["kernel"], arr.T)
        elif arr.ndim == 1:
            # norm-layer weight -> flax 'scale'
            _set_nested(params, path + ["scale"], arr)
        else:
            _set_nested(params, path + ["kernel"], arr)
    return params, stats


def flax_to_torch_state(params: Mapping[str, Any],
                        transpose_names: tuple[str, ...] = ("upv", "up", "deconv")) -> dict:
    """Inverse mapping, for exporting checkpoints back to reference tooling."""
    out: dict = {}

    def walk(node, path):
        if isinstance(node, Mapping) and not (
            {"kernel", "bias", "scale"} & set(node.keys())
        ):
            for k, v in node.items():
                walk(v, path + [k])
            return
        name = ".".join(path)
        if "kernel" in node:
            arr = np.asarray(node["kernel"])
            if arr.ndim == 4:
                if any(path[-1].startswith(t) for t in transpose_names):
                    arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)  # undo the flip
                else:
                    arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T  # flax Dense [in, out] -> torch Linear [out, in]
            out[name + ".weight"] = arr
        if "scale" in node:  # norm-layer weight
            out[name + ".weight"] = np.asarray(node["scale"])
        if "bias" in node:
            out[name + ".bias"] = np.asarray(node["bias"])

    walk(params, [])
    return out


def params_from_jax(params: Mapping[str, Any]) -> dict:
    """JAX parameter tree (numpy leaves, flax layout) -> ``state_dict`` of
    float32 CPU tensors for a module of the UNet family
    (:mod:`pnnp_tpu_torch.models.unet`; nested blocks nest by name, as
    ``conv1.conv1.weight``); ``load_state_dict`` casts them to the module's
    dtype and device."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in flax_to_torch_state(params).items()}


def params_to_jax(state_dict: Mapping[str, Any]) -> dict:
    """Inverse of :func:`params_from_jax`: a module's ``state_dict`` -> JAX
    parameter tree of float32 numpy arrays (the pickle checkpoint layout),
    copied: later updates of the module do not show through."""
    return torch_state_to_flax(
        {k: v.detach().float().cpu().clone() for k, v in state_dict.items()})


def _flat(tree: Mapping[str, Any], path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def flow_params_from_jax(params: Mapping[str, Any],
                         batch_stats: Mapping[str, Any] | None = None) -> dict:
    """A flow's JAX ``params`` and ``batch_stats`` trees (numpy leaves) -> the
    ``state_dict`` of its counterpart in :mod:`pnnp_tpu_torch.models.flows`
    or of :class:`pnnp_tpu_torch.models.NoiseFlow` (module names as
    ``pnnp_tpu/models/noise_flow.py:37-50``), keyed by JAX's module names.
    Conv kernels go HWIO -> OIHW, Dense kernels ``[in, out]`` -> Linear
    ``[out, in]``, BatchNorm ``scale`` becomes ``weight`` and the stats
    ``mean``/``var`` the ``running_*`` buffers; every other leaf keeps its
    path and shape. The ``lu`` dicts of the 1x1 convolutions keep their
    leaf names: ``ConditionalInvertibleConv1x1`` holds ``p`` and ``sign_s``
    as buffers, ``l``/``u``/``log_s`` as parameters, and ``load_state_dict``
    fills both."""
    out = {}
    for path, v in _flat(params):
        arr = np.asarray(v, np.float32)
        *mod, leaf = path
        if leaf == "kernel":
            leaf, arr = "weight", arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
        elif leaf == "scale" and mod and mod[-1].startswith("bn"):
            leaf = "weight"
        # np.array, not ascontiguousarray: the 0-d leaves (gain, beta1, ...) stay 0-d
        out[".".join(mod + [leaf])] = torch.from_numpy(np.array(arr))
    for path, v in _flat(batch_stats or {}):
        *mod, leaf = path
        out[".".join(mod + [f"running_{leaf}"])] = torch.from_numpy(np.array(v, np.float32))
    return out


def flow_params_to_jax(state_dict: Mapping[str, Any]) -> tuple[dict, dict]:
    """Inverse of :func:`flow_params_from_jax`: (params, batch_stats) trees
    of float32 numpy arrays, copied."""
    params: dict = {}
    stats: dict = {}
    for key, val in state_dict.items():
        arr = val.detach().float().cpu().numpy().copy()
        *mod, leaf = key.split(".")
        if leaf.startswith("running_"):
            _set_nested(stats, mod + [leaf[len("running_"):]], arr)
            continue
        if leaf == "weight" and arr.ndim == 4:
            leaf, arr = "kernel", np.array(arr.transpose(2, 3, 1, 0))
        elif leaf == "weight" and arr.ndim == 2:
            leaf, arr = "kernel", np.array(arr.T)
        elif leaf == "weight":
            leaf = "scale"
        _set_nested(params, mod + [leaf], arr)
    return params, stats


def _as_tensor(v) -> torch.Tensor:
    """A tensor (detached, on the CPU) or an array-like as a CPU tensor."""
    return v.detach().cpu() if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))


def eld_checkpoint_state_dict(path: str) -> dict:
    """An ELD-format torch checkpoint (``{'netG': state_dict}``, or a bare
    ``{'state_dict': ...}``) as this package's ``state_dict`` of float32 CPU
    tensors, the DataParallel ``module.`` prefix stripped and
    ``num_batches_tracked`` dropped. The reference's layer names are the
    port's, so it loads into the module as it is. Counterpart of
    ``pnnp_tpu/models/convert.py::eld_checkpoint_to_flax`` (the reference's
    pth_transfer, utils/utils.py:257-270), which returns flax params."""
    state = torch.load(path, map_location="cpu")
    if isinstance(state, dict) and "netG" in state:
        state = state["netG"]
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    out = {}
    for key, val in state.items():
        key = key[len("module."):] if key.startswith("module.") else key
        if key.rsplit(".", 1)[-1] != "num_batches_tracked":
            out[key] = _as_tensor(val).float()
    return out


def load_tolerant(target: Mapping[str, Any], loaded: Mapping[str, Any],
                  by_name: bool = True) -> dict:
    """Name- and shape-tolerant merge of the state dict ``loaded`` into
    ``target`` (counterpart of ``pnnp_tpu/models/convert.py::load_tolerant``,
    the reference's forgiving loader, utils/utils.py:148-192): an entry of
    ``target`` keeps its value, with a warning, where ``loaded`` lacks the
    name or holds another shape (that warning only with ``by_name``);
    otherwise it takes ``loaded``'s value in ``target``'s dtype. Names only
    in ``loaded`` are dropped. Returns a new dict of ``target``'s names."""
    merged = {}
    for name, tv in target.items():
        lv = loaded.get(name)
        if lv is not None and tuple(np.shape(lv)) == tuple(tv.shape):
            merged[name] = _as_tensor(lv).to(dtype=tv.dtype)
            continue
        if lv is not None and by_name:
            warnings.warn(f"shape mismatch for {name}; keeping init")
        elif lv is None:
            warnings.warn(f"missing {name} in checkpoint; keeping init")
        merged[name] = tv
    return merged
