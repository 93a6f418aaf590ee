"""The torch-free .pth reader (weights.torch_import.load_pth) against
torch.load, on the committed trained checkpoints and on one synthetic
checkpoint of each container flavor the loaders sniff."""

import os
import pickle
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from multi_style_transfer_gan.weights import (  # noqa: E402
    extract_state_dict, load_pth,
)
from multi_style_transfer_gan.weights.torch_import import (  # noqa: E402
    _STATE_DICT_KEYS,
)


def _assert_same(got, ref, path="ckpt"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), path
        for k in ref:
            _assert_same(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, torch.Tensor):
        t = ref.detach()
        want = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        have = (np.asarray(got, np.float32) if t.dtype == torch.bfloat16
                else got)
        assert isinstance(got, np.ndarray), (path, type(got))
        assert have.dtype == want.dtype and have.shape == want.shape, path
        np.testing.assert_array_equal(have, want)
    else:
        assert got == ref, path


@pytest.mark.parametrize("name", ["G_AB_selected.pth", "G_BA_selected.pth"])
def test_load_pth_matches_torch_on_trained(name):
    path = os.path.join("trained", name)
    _assert_same(load_pth(path),
                 torch.load(path, map_location="cpu", weights_only=False))


@pytest.mark.parametrize("key", _STATE_DICT_KEYS)
def test_load_pth_matches_torch_per_flavor(tmp_path, key):
    """Parameters, strided views sharing one storage, every common dtype
    and 0-d tensors, under each container key."""
    g = torch.Generator().manual_seed(len(key))
    base = torch.randn(2, 3, 4, generator=g)
    sd = {
        "conv.weight": torch.nn.Parameter(torch.randn(8, 3, 3, 3,
                                                      generator=g)),
        "transposed": base.transpose(0, 2),
        "strided": base[1, 1:, ::2],
        "half": torch.randn(5, generator=g).half(),
        "bf16": torch.randn(5, generator=g).bfloat16(),
        "double": torch.randn(3, generator=g).double(),
        "num_batches_tracked": torch.tensor(7),
        "ints": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "mask": torch.tensor([True, False, True]),
    }
    path = tmp_path / "ckpt.pth"
    torch.save({"epoch": 3, key: sd}, path)
    got = load_pth(path)
    _assert_same(got, torch.load(path, weights_only=False))
    picked = extract_state_dict(got)
    assert list(picked) == list(sd)


def test_load_pth_refuses_foreign_globals(tmp_path):
    """A pickle that names any other global is refused, never called."""
    class Boom:
        def __reduce__(self):
            return (os.system, ("echo pwned",))

    path = tmp_path / "evil.pth"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("evil/data.pkl", pickle.dumps({"w": Boom()}, protocol=2))
    with pytest.raises(pickle.UnpicklingError, match="system"):
        load_pth(path)


def test_load_pth_rejects_non_zip(tmp_path):
    path = tmp_path / "legacy.pth"
    path.write_bytes(pickle.dumps({"w": 1}))
    with pytest.raises(zipfile.BadZipFile):
        load_pth(path)
