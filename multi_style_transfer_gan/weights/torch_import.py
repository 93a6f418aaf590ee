"""PyTorch ``.pth`` checkpoint import/export.

Capability parity with the reference's checkpoint tooling:
- format sniffing over every checkpoint flavor the reference produces
  (convert_model.py:12-29; loaders at direct_transform.py:15-22 and
  batch_process_images.py:75-80, including the legacy ``G_A``/``G_B`` keys),
- channel auto-detection from ``initial.0.weight`` (direct_transform.py:25-30),
- ``convert_model`` / ``pth_info`` equivalents (convert_model.py, pth_info.py).

Layout conversion (torch -> ours):
- Conv2d weight  (O, I, kh, kw) -> (kh, kw, I, O)   [HWIO]
- ConvTranspose2d weight (I, O, kh, kw) -> (kh, kw, I, O)
- Linear (out, in) kept as-is; 1-D tensors kept; ``num_batches_tracked``
  dropped; spectral-norm ``weight_v`` dropped (recomputed from u).

Reading needs no torch: ``load_pth`` parses torch's zip format with a
restricted unpickler. Writing (``save_pth``) uses torch where it is
installed.
"""

from __future__ import annotations

import io
import os
import pickle
import zipfile
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np

import jax.numpy as jnp

# Checkpoint container keys, in sniffing order (convert_model.py:12-29 plus
# the legacy G_A/G_B pair accepted by batch_process_images.py:78-80).
_STATE_DICT_KEYS = (
    "G_AB_state_dict", "G_BA_state_dict", "G_A", "G_B",
    "state_dict", "model_state_dict",
    "D_A_state_dict", "D_B_state_dict",
)

# Keys holding transposed convs, per model family.
_PLAIN_TRANSPOSED = {"decoder.0", "decoder.3", "decoder.6", "decoder.9"}
_ENH_TRANSPOSED = {"up1.0", "up2.0"}


# torch storage class name -> numpy dtype, for the reader below.
_STORAGE_DTYPES = {
    "FloatStorage": np.float32, "DoubleStorage": np.float64,
    "HalfStorage": np.float16, "BFloat16Storage": jnp.bfloat16,
    "LongStorage": np.int64, "IntStorage": np.int32,
    "ShortStorage": np.int16, "CharStorage": np.int8,
    "ByteStorage": np.uint8, "BoolStorage": np.bool_,
    "UntypedStorage": np.uint8,
}


class _Storage:
    """What a pickled storage class resolves to: its element dtype."""

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)


def _rebuild_tensor(storage, offset, size, stride, *_):
    """torch._utils._rebuild_tensor_v2 as numpy: a strided view of the
    storage's elements, copied out."""
    itemsize = storage.dtype.itemsize
    if not size:
        return np.array(storage[offset])
    return np.lib.stride_tricks.as_strided(
        storage[offset:], shape=tuple(size),
        strides=tuple(st * itemsize for st in stride)).copy()


def _rebuild_parameter(data, *_):
    return data


class _PthUnpickler(pickle.Unpickler):
    """Rebuilds tensors as numpy arrays. Resolves only the handful of
    globals a state-dict checkpoint holds and refuses every other one, so
    loading runs no code from the file."""

    _GLOBALS = {
        ("collections", "OrderedDict"): OrderedDict,
        ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor,
        ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
    }

    def __init__(self, data: bytes, read_record):
        super().__init__(io.BytesIO(data))
        self._read_record = read_record
        self._storages = {}

    def find_class(self, module, name):
        if module == "torch" and name in _STORAGE_DTYPES:
            return _Storage(_STORAGE_DTYPES[name])
        try:
            return self._GLOBALS[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"checkpoint refers to {module}.{name}, which a state-dict "
                "checkpoint does not hold") from None

    def persistent_load(self, pid):
        kind, storage, key, _location, numel = pid
        if kind != "storage" or not isinstance(storage, _Storage):
            raise pickle.UnpicklingError(f"unsupported persistent id {pid}")
        if key not in self._storages:
            raw = self._read_record(f"data/{key}")
            self._storages[key] = np.frombuffer(
                raw, dtype=storage.dtype, count=numel)
        return self._storages[key]


def load_pth(path):
    """Load a .pth written by ``torch.save`` (its zip format) to nested
    dicts of numpy arrays, without torch."""
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        pkl = [n for n in names if n.endswith("/data.pkl")]
        if not pkl:
            raise ValueError(f"{path} is not a torch zip checkpoint")
        prefix = pkl[0][:-len("data.pkl")]
        if f"{prefix}byteorder" in names:
            order = zf.read(f"{prefix}byteorder").decode().strip()
            if order != "little":
                raise ValueError(f"{path}: unsupported byte order {order}")
        return _PthUnpickler(
            zf.read(pkl[0]),
            lambda record: zf.read(prefix + record)).load()


def _to_numpy(v):
    if hasattr(v, "detach"):  # a torch tensor handed in by a caller
        return v.detach().cpu().numpy()
    return np.asarray(v)


def extract_state_dict(ckpt, prefer: str | None = None) -> Dict[str, np.ndarray]:
    """Pull the flat state dict out of any reference checkpoint flavor.

    ``prefer`` selects a specific container key (e.g. "G_AB_state_dict") when
    a checkpoint holds several; otherwise the first present key wins, and a
    bare state dict passes through (with ``epoch``/``G_*`` metadata stripped,
    mirroring convert_model.py:22-26).
    """
    if not isinstance(ckpt, dict):
        raise ValueError(f"unsupported checkpoint object: {type(ckpt)}")
    if prefer is not None:
        if prefer not in ckpt:
            raise KeyError(f"checkpoint has no '{prefer}' "
                           f"(keys: {list(ckpt)[:8]})")
        sd = ckpt[prefer]
    else:
        sd = None
        for k in _STATE_DICT_KEYS:
            if k in ckpt:
                sd = ckpt[k]
                break
        if sd is None:
            sd = {k: v for k, v in ckpt.items()
                  if k != "epoch" and not k.startswith("G_")
                  and hasattr(v, "shape")}
    return {k: _to_numpy(v) for k, v in sd.items()}


def detect_model_kind(sd: Dict[str, np.ndarray]) -> str:
    """'plain' (encoder/decoder Generator) vs 'enhanced' vs 'discriminator'."""
    if any(k.startswith("encoder.") for k in sd):
        return "plain"
    if any(k.startswith("initial.") for k in sd):
        return "enhanced"
    if any(k.startswith("main.") for k in sd):
        return "discriminator"
    raise ValueError(f"unrecognized state dict (keys: {list(sd)[:8]})")


def detect_channels(sd: Dict[str, np.ndarray]) -> int:
    """Channel width sniffing, like direct_transform.py:25-30."""
    kind = detect_model_kind(sd)
    if kind == "plain":
        return sd["encoder.0.weight"].shape[0]
    if kind == "enhanced":
        return sd["initial.0.weight"].shape[0]
    key = "main.0.weight_orig" if "main.0.weight_orig" in sd else "main.0.weight"
    return sd[key].shape[0]


def _import_tensor(key: str, v: np.ndarray, transposed_prefixes) -> np.ndarray:
    if v.ndim == 4:
        prefix = key.rsplit(".", 1)[0]
        if prefix in transposed_prefixes:
            return np.transpose(v, (2, 3, 0, 1))  # IOHW -> HWIO
        return np.transpose(v, (2, 3, 1, 0))      # OIHW -> HWIO
    return v


def _import_sd(sd, transposed_prefixes, dtype,
               keep_weight_v=False) -> Dict[str, np.ndarray]:
    """Returns HOST numpy arrays, deliberately: checkpoint import must not
    touch the accelerator (one eager device transfer per tensor would be
    ~90 transfers at load time); jit boundaries and replicate_tree transfer
    the tree when it is used."""
    params = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("weight_v") and not keep_weight_v:
            continue
        arr = _import_tensor(k, np.asarray(v), transposed_prefixes)
        if k.endswith(("running_mean", "running_var", "weight_u", "weight_v")):
            params[k] = np.asarray(arr, np.float32)
        else:
            params[k] = np.asarray(arr, np.dtype(dtype))
    return params


def _convert_weight_v(v_torch: np.ndarray, oihw_shape) -> np.ndarray:
    """Reorder a torch ``weight_v`` (flat over (I, kh, kw)) to our flat order
    over (kh, kw, I) — see core.norm.spectral_normalize."""
    o, i, kh, kw = oihw_shape
    return np.ascontiguousarray(
        v_torch.reshape(i, kh, kw).transpose(1, 2, 0).reshape(-1))


def plain_generator_from_sd(sd, dtype=jnp.float32):
    return _import_sd(sd, _PLAIN_TRANSPOSED, dtype)


def enhanced_generator_from_sd(sd, dtype=jnp.float32):
    return _import_sd(sd, _ENH_TRANSPOSED, dtype)


def discriminator_from_sd(sd, dtype=jnp.float32):
    """Returns (params, sn_state): weight_u/weight_v buffers split per conv as
    ``sn_state[name] = {"u": ..., "v": ...}`` (v reordered to our layout)."""
    params, sn_state = {}, {}
    for k, v in sd.items():
        arr = np.asarray(v)
        name = k.rsplit(".", 1)[0]
        if k.endswith(".weight_u"):
            sn_state.setdefault(name, {})["u"] = np.asarray(arr, np.float32)
        elif k.endswith(".weight_v"):
            oihw = np.asarray(sd[f"{name}.weight_orig"]).shape
            sn_state.setdefault(name, {})["v"] = np.asarray(
                _convert_weight_v(arr, oihw), np.float32)
        elif k.endswith(".weight"):
            # un-wrapped checkpoint (plain conv weights, no SN buffers)
            params[k + "_orig"] = np.asarray(
                _import_tensor(k, arr, set()), np.dtype(dtype))
            sn_state.setdefault(name, {})
        elif k.endswith("num_batches_tracked"):
            continue
        else:
            params[k] = np.asarray(_import_tensor(k, arr, set()),
                                   np.dtype(dtype))
    for name, st in sn_state.items():
        if "u" not in st:
            cout = params[f"{name}.weight_orig"].shape[-1]
            v0 = np.random.default_rng(0).standard_normal(cout).astype(np.float32)
            st["u"] = v0 / np.linalg.norm(v0)
        st.setdefault("v", None)
    return params, sn_state


def params_to_torch_sd(params, kind: str):
    """Export our param dict back to a torch-layout state dict (numpy values).

    Inverse of the importers — usable with ``save_pth`` to produce checkpoints
    the PyTorch reference can load.
    """
    transposed = _PLAIN_TRANSPOSED if kind == "plain" else (
        _ENH_TRANSPOSED if kind == "enhanced" else set())
    sd = {}
    for k, v in params.items():
        arr = np.asarray(v)
        if arr.ndim == 4:
            prefix = k.rsplit(".", 1)[0]
            if prefix in transposed:
                arr = np.transpose(arr, (2, 3, 0, 1))
            else:
                arr = np.transpose(arr, (3, 2, 0, 1))
        sd[k] = arr
    return sd


def trainable_keys(params) -> list:
    """Keys in ``model.parameters()`` order: the state-dict key order minus
    the BatchNorm buffers (torch registers weight/bias before the buffers,
    so filtering the ordered dict reproduces parameters() exactly)."""
    return [k for k in params
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))]


def adam_state_to_torch(params, mu, nu, count, kind: str, lr: float,
                        betas=(0.5, 0.999), eps: float = 1e-8):
    """Build a ``torch.optim.Adam.state_dict()`` from optax adam moments so
    the PyTorch reference can ``optimizer.load_state_dict`` our checkpoints
    (pretrain_resume.py:134-157). Moment tensors get the same layout
    transposes as the weights they correspond to."""
    keys = trainable_keys(params)
    mu_sd = params_to_torch_sd({k: mu[k] for k in keys}, kind)
    nu_sd = params_to_torch_sd({k: nu[k] for k in keys}, kind)
    step = np.asarray(float(count), np.float32)
    return {
        "state": {i: {"step": step,
                      "exp_avg": mu_sd[k],
                      "exp_avg_sq": nu_sd[k]} for i, k in enumerate(keys)},
        "param_groups": [{
            "lr": float(lr), "betas": tuple(betas), "eps": float(eps),
            "weight_decay": 0, "amsgrad": False, "maximize": False,
            "foreach": None, "capturable": False, "differentiable": False,
            "fused": None, "params": list(range(len(keys))),
        }],
    }


def adam_state_from_torch(opt_sd, params, kind: str):
    """Inverse of ``adam_state_to_torch``: (mu, nu, count) trees matching
    ``params`` (buffer entries zero, as optax init leaves them)."""
    transposed = _PLAIN_TRANSPOSED if kind == "plain" else (
        _ENH_TRANSPOSED if kind == "enhanced" else set())
    keys = trainable_keys(params)
    mu = {k: jnp.zeros_like(v) for k, v in params.items()}
    nu = {k: jnp.zeros_like(v) for k, v in params.items()}
    count = 0
    for i, k in enumerate(keys):
        st = opt_sd["state"].get(i, opt_sd["state"].get(str(i)))
        if st is None:
            continue
        mu[k] = jnp.asarray(
            _import_tensor(k, np.asarray(_to_numpy(st["exp_avg"])),
                           transposed), params[k].dtype)
        nu[k] = jnp.asarray(
            _import_tensor(k, np.asarray(_to_numpy(st["exp_avg_sq"])),
                           transposed), params[k].dtype)
        count = int(round(float(np.asarray(_to_numpy(st["step"])).reshape(-1)[0])))
    return mu, nu, count


def save_pth(obj, path):
    """Serialize with torch.save (tensors converted from numpy); needs
    torch."""
    import torch

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, np.ndarray):
            arr = np.ascontiguousarray(v)
            if not arr.flags.writeable:  # torch warns on non-writable views
                arr = arr.copy()
            return torch.from_numpy(arr)
        if isinstance(v, jnp.ndarray):
            # np.asarray(jax array) is a non-writable view; torch warns on
            # from_numpy over those — hand it a writable copy instead.
            arr = np.ascontiguousarray(np.asarray(v))
            if not arr.flags.writeable:
                arr = arr.copy()
            return torch.from_numpy(arr)
        return v

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    import torch as _t
    _t.save(conv(obj), path)


def convert_model(input_path, output_path) -> bool:
    """CLI-parity with convert_model.py: normalize any checkpoint flavor into
    a flat state-dict .pth."""
    try:
        ckpt = load_pth(input_path)
        sd = extract_state_dict(ckpt)
        save_pth(sd, output_path)
        print(f"model converted and saved to {output_path}")
        return True
    except Exception as e:  # mirror the reference's tolerant CLI behavior
        print(f"conversion failed: {e}")
        return False


def pth_info(path) -> list[str]:
    """Print name: shape for every tensor (pth_info.py parity)."""
    ckpt = load_pth(path)
    sd = extract_state_dict(ckpt)
    lines = [f"{k}: {tuple(np.asarray(v).shape)}" for k, v in sd.items()]
    for line in lines:
        print(line)
    return lines
