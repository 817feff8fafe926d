"""``bn_warmup`` (``tdnet_torch/train/weights.py``) against
``tdnet.train.weights.bn_warmup`` on the CPU: the same ResNet-50 RetinaNet
variables and the same batches (uint8 pages, the prefetcher's packed rows
and normalized float images; caffe and tf modes) give the same new
``batch_stats`` within a tolerance scaled to each leaf, and the passes
run the unfused modules with the recording hooks gone afterwards."""

import ctypes
import gc

import numpy as np
import pytest
import torch

from tdnet_torch.models.retinanet import RetinaNet
from tdnet_torch.train.weights import bn_warmup
from tdnet_torch.weights import random_variables

torch.set_num_threads(1)  # tier-1 runs several xdist workers

# new statistics within RTOL plus ATOL times the leaf's largest magnitude
# (the two frameworks sum each mean in another order; var = E[x^2] - E[x]^2
# cancels where the mean dominates)
RTOL, ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _release_memory():
    yield
    import jax

    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:  # not glibc: nothing to trim
        pass


@pytest.fixture(scope="module")
def variables():
    return random_variables(1, "resnet50", seed=2)


def _pages(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8) for _ in range(n)]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


CASES = {
    "caffe-uint8": ("caffe", lambda: _pages(2, 0)),
    "tf-packed-rows": ("tf", lambda: [p.reshape(2, 64, 96 * 3) for p in _pages(2, 1)]),
    "float-dicts": ("caffe", lambda: [{"images": (p.astype(np.float32) - 120) / 60}
                                      for p in _pages(3, 2)]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bn_warmup_equals_reference(variables, case, capsys):
    from tdnet.models import backbone as ref_backbone
    from tdnet.train.weights import bn_warmup as ref_warmup

    mode, make = CASES[case]
    batches = make()
    got = bn_warmup(RetinaNet(1), variables, iter(batches), num_batches=5,
                    preprocess_mode=mode, device="cpu")
    got_out = capsys.readouterr().out
    want = ref_warmup(ref_backbone("resnet50").retinanet(1), variables, iter(batches),
                      num_batches=5, preprocess_mode=mode)
    assert capsys.readouterr().out == got_out == (
        f"bn_warmup: re-estimated BatchNorm statistics from {len(batches)} batches\n")
    assert got["params"] is variables["params"]
    want_stats = dict(_leaves(want["batch_stats"]))
    got_stats = dict(_leaves(got["batch_stats"]))
    assert got_stats.keys() == want_stats.keys()
    worst = 0.0
    for path, w in want_stats.items():
        w, g = np.asarray(w), got_stats[path]
        assert g.dtype == w.dtype == np.float32, path
        assert not np.array_equal(g, np.asarray(dict(_leaves(variables["batch_stats"]))[path]))
        tol = RTOL * np.abs(w) + ATOL * np.abs(w).max()
        worst = max(worst, float((np.abs(g - w) / (np.abs(w) + np.abs(w).max())).max()))
        assert (np.abs(g - w) <= tol).all(), (path, float(np.abs(g - w).max()))
    print(f"{case}: largest |got - want| / (|want| + max|want|) = {worst:.3g}")


def test_bn_warmup_runs_the_unfused_modules(variables, monkeypatch):
    """The recording needs every BN input, so the passes call the model
    with ``stem_input=False, block_kernel=False`` even when the model's
    own flag would take the fused bottleneck kernel; no hook is left."""
    model = RetinaNet(1, block_kernel=True)
    calls = []
    forward = model.forward
    monkeypatch.setattr(model, "forward", lambda images, **kw: (calls.append(kw),
                                                                forward(images, **kw))[1])
    bn_warmup(model, variables, iter(_pages(1, 3)), num_batches=1, verbose=False,
              device="cpu")
    assert calls == [{"stem_input": False, "block_kernel": False}]
    assert not any(m._forward_pre_hooks for m in model.modules())
    with pytest.raises(ValueError, match="no batches"):
        bn_warmup(model, variables, iter([]), device="cpu")
