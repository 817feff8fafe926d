"""The port's training path on the CPU against tdnet's: box encoding,
losses, anchor targets, per-tensor clipping and Adam, and one whole train
step (float and packed-uint8 batches, ResNet-50 RetinaNet, f32) against
``tdnet.train.step.make_train_step`` on the same variables and batch. Also
the device choice of the entry points and the ``TDNET_STEM_BWD`` switch.
Inputs come from numpy seeds; both sides get the same arrays."""

import ctypes
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdnet_torch.models.retinanet import RetinaNet
from tdnet_torch.train.step import (ClippedAdam, clip_by_leaf_norm_,
                                    create_optimizer, create_train_state,
                                    make_eval_step, make_train_step)
from tdnet_torch.weights import random_variables, variables_from_torch_state

torch.set_num_threads(1)  # tier-1 runs several xdist workers

H, W = 64, 96
LR, CLIPNORM = 1e-4, 1e-3


@pytest.fixture(scope="module")
def variables():
    return random_variables(1, "resnet50", seed=0)


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_executables():
    """The ResNet-50 executables compiled here are not reused elsewhere; the
    tier-1 workers run hundreds of tests each and their memory adds up. This
    module's gradients and parameters (~2.8 GB, torn down before this
    fixture) stay in the C heap after they are freed unless it is trimmed."""
    yield
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:  # not glibc: nothing to trim
        pass


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _batch(b=2, seed=1, packed=False):
    """Integer-valued pages (so the float and uint8 routes see the same
    values), one real GT box and one padded slot per image."""
    from tdnet_torch.data.image import CAFFE_MEAN_BGR

    raw = np.random.RandomState(seed).randint(0, 256, (b, H, W, 3)).astype(np.uint8)
    images = raw.reshape(b, H, W * 3) if packed else raw.astype(np.float32) - CAFFE_MEAN_BGR
    return {
        "images": images,
        "gt_boxes": np.tile(np.array([[10.0, 10.0, 50.0, 40.0],
                                      [30.0, 20.0, 90.0, 60.0]], np.float32), (b, 1, 1)),
        "gt_labels": np.zeros((b, 2), np.int32),
        "gt_mask": np.tile(np.array([True, False]), (b, 1)),
        "image_hw": np.tile(np.array([H, W], np.float32), (b, 1)),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


# ------------------------------------------------------------ device choice


def test_entry_points_default_to_cuda_and_raise_without_it(variables):
    """No device means CUDA: without a GPU the Predictor, the train state
    and the prefetcher raise instead of running on the CPU."""
    from tdnet_torch.data.prefetch import DevicePrefetcher
    from tdnet_torch.device import resolve_device
    from tdnet_torch.train.predictor import Predictor

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        Predictor(RetinaNet(1))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        create_train_state(RetinaNet(1), variables)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        DevicePrefetcher(iter([]))


# ------------------------------------------------------ boxes, losses, targets


def test_bbox_transform_matches_reference():
    """rtol 1e-6: the same IEEE subtract/divide sequence on both sides."""
    from tdnet.ops.boxes import bbox_transform as ref
    from tdnet_torch.ops.boxes import bbox_transform, bbox_transform_inv

    rng = np.random.RandomState(0)
    a = rng.uniform(0, 100, (300, 4)).astype(np.float32)
    a[:, 2:] = a[:, :2] + rng.uniform(4, 60, (300, 2)).astype(np.float32)
    g = a + rng.normal(0, 5, (300, 4)).astype(np.float32)
    want = np.asarray(ref(jnp.asarray(a), jnp.asarray(g)))
    got = bbox_transform(torch.from_numpy(a), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    back = bbox_transform_inv(torch.from_numpy(a), got)  # the exact inverse
    np.testing.assert_allclose(back.numpy(), g, rtol=1e-5, atol=1e-4)


def _loss_inputs(case, seed=2, b=2, n=500, k=3):
    rng = np.random.RandomState(seed)
    state = rng.choice([-1.0, 0.0, 1.0], size=(b, n), p=[0.2, 0.7, 0.1])
    if case == "all_negative":
        state[:] = 0.0
    elif case == "all_ignored":
        state[:] = -1.0
    cls = np.zeros((b, n, k))
    cls[np.arange(b)[:, None], np.arange(n)[None], rng.randint(0, k, (b, n))] = 1.0
    cls[state != 1.0] = 0.0
    labels = np.concatenate([cls, state[..., None]], -1).astype(np.float32)
    reg = np.concatenate([rng.normal(0, 0.3, (b, n, 4)), state[..., None]],
                         -1).astype(np.float32)
    logits = rng.normal(-1.0, 3.0, (b, n, k)).astype(np.float32)
    deltas = rng.normal(0, 0.3, (b, n, 4)).astype(np.float32)
    return labels, reg, logits, deltas


@pytest.mark.parametrize("case", ["random", "all_negative", "all_ignored"])
@pytest.mark.parametrize("from_logits", [True, False])
def test_losses_match_reference(case, from_logits):
    """Focal (from logits, and from clipped probabilities) and smooth-L1:
    rtol 1e-6 (elementwise exp/log from different libraries, and sums in
    another order)."""
    from tdnet.ops.losses import focal as ref_focal
    from tdnet.ops.losses import smooth_l1 as ref_l1
    from tdnet_torch.ops.losses import focal, smooth_l1

    labels, reg, logits, deltas = _loss_inputs(case)
    pred = logits if from_logits else 1.0 / (1.0 + np.exp(-logits))
    pred = pred.astype(np.float32)
    want = float(ref_focal(from_logits=from_logits)(jnp.asarray(labels), jnp.asarray(pred)))
    got = float(focal(from_logits=from_logits)(torch.from_numpy(labels),
                                               torch.from_numpy(pred)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want = float(ref_l1()(jnp.asarray(reg), jnp.asarray(deltas)))
    got = float(smooth_l1()(torch.from_numpy(reg), torch.from_numpy(deltas)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if case == "all_ignored":
        assert got == 0.0


def test_anchor_targets_match_reference():
    """Labels and anchor states exact, regression rtol 1e-6, on: random GT
    with padded slots that would match if they counted, two identical GT
    boxes of different classes (the lower index wins), an image with no GT,
    and a small unpadded image whose far anchors have centres outside it."""
    from tdnet.ops.targets import batched_anchor_targets as ref
    from tdnet_torch.ops.anchors import anchors_for_shape
    from tdnet_torch.ops.targets import anchor_targets, batched_anchor_targets

    anchors = anchors_for_shape((H, W)).astype(np.float32)
    rng = np.random.RandomState(3)
    m = 5
    boxes = np.zeros((4, m, 4), np.float32)
    labels = rng.randint(0, 3, (4, m)).astype(np.int32)
    mask = np.zeros((4, m), bool)
    for i in range(4):
        xy = rng.uniform(0, 40, (m, 2))
        boxes[i, :, :2] = xy
        boxes[i, :, 2:] = xy + rng.uniform(12, 50, (m, 2))
    mask[0, :3] = True                     # slots 3, 4 padded but overlapping
    boxes[1, 1] = boxes[1, 2] = [8.0, 8.0, 40.0, 36.0]  # an exact tie...
    labels[1, 1], labels[1, 2] = 2, 1                    # ...of two classes
    boxes[1, 0] = boxes[1, 1]                            # padded twin first
    mask[1, 1:3] = True
    mask[3, :2] = True                     # image 2: no GT at all
    hw = np.array([[H, W], [H, W], [H, W], [40, 60]], np.float32)

    want_l, want_r = (np.asarray(x) for x in ref(
        jnp.asarray(anchors), jnp.asarray(boxes), jnp.asarray(labels),
        jnp.asarray(mask), jnp.asarray(hw), 3))
    got_l, got_r = batched_anchor_targets(
        torch.from_numpy(anchors), torch.from_numpy(boxes),
        torch.from_numpy(labels), torch.from_numpy(mask), torch.from_numpy(hw), 3)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    np.testing.assert_array_equal(got_r.numpy()[..., 4], want_r[..., 4])
    np.testing.assert_allclose(got_r.numpy(), want_r, rtol=1e-6, atol=1e-6)

    state = want_l[..., -1]
    cx, cy = anchors[:, 0::2].mean(1), anchors[:, 1::2].mean(1)
    # no GT: negative except the anchors centred outside the canvas
    np.testing.assert_array_equal(state[2] == -1, (cx >= W) | (cy >= H))
    assert (state[2] != 1).all()
    assert (state[1] == 1).any() and (want_l[1][state[1] == 1, 2] == 1).all()
    assert ((state[3] == -1).sum() > (state[0] == -1).sum())
    one_l, one_r = anchor_targets(torch.from_numpy(anchors), torch.from_numpy(boxes[1]),
                                  torch.from_numpy(labels[1]), torch.from_numpy(mask[1]),
                                  torch.from_numpy(hw[1]), 3)
    assert torch.equal(one_l, got_l[1]) and torch.equal(one_r, got_r[1])


def test_argmax_takes_the_first_maximum():
    """The tie order anchor_targets relies on (checked on the GPU too by
    chip_smoke's train phase through the whole step)."""
    x = torch.tensor([[0.5, 0.7, 0.7, 0.1], [0.2, 0.2, 0.2, 0.2]])
    assert torch.argmax(x, dim=1).tolist() == [1, 0]


# ------------------------------------------------------------- optimizer


def test_clip_by_leaf_norm():
    grads = [torch.full((4,), 10.0), torch.full((2,), 0.1)]
    clip_by_leaf_norm_(grads, 1.0)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(grads[0])), 1.0, rtol=1e-5)
    np.testing.assert_allclose(grads[1].numpy(), 0.1, rtol=1e-5)  # untouched


def test_clipped_adam_matches_optax():
    """Three steps of ClippedAdam against tdnet's create_optimizer (optax
    per-leaf clip + adam) on the same gradients: updates rtol 1e-5 (the two
    order the bias corrections differently), atol 4e-7 (the updates are read
    off parameters of magnitude ~1, whose f32 ulp is 1.2e-7)."""
    from tdnet.train.step import create_optimizer as ref_opt

    rng = np.random.RandomState(4)
    init = {"a": rng.normal(0, 1, (30, 7)).astype(np.float32),
            "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    grads = [{k: rng.normal(0, s, v.shape).astype(np.float32) for k, v in init.items()}
             for s in (1.0, 1e-3, 3.0)]
    tx = ref_opt(learning_rate=1e-2, clipnorm=0.5)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in init.items()}
    opt = ClippedAdam(list(tp.values()), lr=1e-2, clipnorm=0.5)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, params)
        params = {k: params[k] + updates[k] for k in params}
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in init:
        np.testing.assert_allclose(tp[k].detach().numpy() - init[k],
                                   np.asarray(params[k]) - init[k], rtol=1e-5, atol=4e-7)


# ------------------------------------------------------------- train step


class _GrabAdam(ClippedAdam):
    """Keeps the raw (pre-clip) gradients of the last step."""

    def step(self, closure=None):
        self.raw = [p.grad.clone() for g in self.param_groups for p in g["params"]]
        return super().step(closure)


def _jax_step(variables, batch):
    """tdnet's train step on the same variables: metrics, raw gradients
    (captured by a pass-through transformation ahead of the optimizer) and
    the parameters after one clipped Adam step."""
    import optax
    from tdnet.models.retinanet import RetinaNet as FlaxRetinaNet
    from tdnet.train.step import TrainState
    from tdnet.train.step import create_optimizer as ref_opt
    from tdnet.train.step import make_train_step as ref_step

    grab = optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda u, s, p=None: (u, {"g": u}))
    tx = optax.chain(grab, ref_opt(LR, CLIPNORM))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(params), tx=tx)
    model = FlaxRetinaNet(num_classes=1, dtype=jnp.float32)
    new, metrics = ref_step(model, num_classes=1)(state, batch)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return ({k: np.asarray(v) for k, v in metrics.items()},
            to_np(new.opt_state[0]["g"]), to_np(new.params))


def _port_step(variables, batch, fused_stem):
    model = RetinaNet(1)
    state = create_train_state(
        model, variables, device="cpu",
        optimizer=lambda p: _GrabAdam(p, lr=LR, clipnorm=CLIPNORM))
    step = make_train_step(model, num_classes=1, fused_stem=fused_stem)
    state, metrics = step(state, _torch_batch(batch))
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = variables_from_torch_state(dict(zip(names, state.optimizer.raw)))
    return ({k: v.numpy() for k, v in metrics.items()}, grads["params"],
            variables_from_torch_state(model.state_dict())["params"], state.step)


@pytest.fixture(scope="module")
def step_pair(variables):
    """(jax, port) results for the float and the packed-uint8 batch; the
    port runs the packed batch through the fused stem (plain versions)."""
    out = {}
    for name, packed in (("float", False), ("packed", True)):
        batch = _batch(packed=packed)
        out[name] = (_jax_step(variables, batch),
                     _port_step(variables, batch, fused_stem=packed))
    return out


@pytest.mark.parametrize("route", ["float", "packed"])
def test_train_step_matches_reference(step_pair, variables, route):
    """One train step, f32, 2 images at 64x96. Metrics rtol 1e-4 and
    num_positive exact. Gradients: a ReLU whose input lies within float
    noise of 0 can flip between the frameworks, and a flip moves every
    gradient upstream of it; each f32 run flips a few against an f64 run,
    at layers that depend on the summation order (the thread count, the CPU
    kernels). tools/torch_grad_parity.py measures it: worst tensor 1.1e-2
    relative Frobenius, whole gradient up to 5.7e-4. So each tensor is held
    to a relative Frobenius error <= 3e-2, floored at 1e-3 of the largest
    tensor's norm (P6/P7 get ~1e-6 of the other gradients, differences of
    much larger terms), and the whole gradient to <= 5e-3. After the
    clipped Adam step every element moved by at most lr on both sides (the
    first step is lr * g / (|g| + eps)), and at most 5% of the elements
    differ by more than 1e-3 * lr + 1e-7: where g is inside the gradient
    noise its sign, and so its step, can differ (measured up to 1.8%)."""
    (jm, jg, jp), (tm, tg, tp, steps) = step_pair[route]
    assert steps == 1
    assert int(tm["num_positive"]) == int(jm["num_positive"]) > 0
    for k in ("loss", "classification_loss", "regression_loss", "grad_norm"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
    tg, tp, jp = dict(_leaves(tg)), dict(_leaves(tp)), dict(_leaves(jp))
    before = dict(_leaves(variables["params"]))
    biggest = max(np.linalg.norm(g) for _, g in _leaves(jg))
    err2 = ref2 = 0.0
    n_params = n_apart = 0
    for path, g in _leaves(jg):
        if path not in tg:  # frozen BN scale/bias: no gradient in the port
            assert path[-1] in ("scale", "bias") and not np.any(g), path
            np.testing.assert_array_equal(tp[path], before[path])
            continue
        d = (tg[path] - g).astype(np.float64)
        norm = np.linalg.norm(g.astype(np.float64))
        assert np.linalg.norm(d) <= 3e-2 * max(norm, 1e-3 * biggest), path
        err2 += float((d ** 2).sum())
        ref2 += norm ** 2
        moved_t, moved_j = tp[path] - before[path], jp[path] - before[path]
        assert max(np.abs(moved_t).max(), np.abs(moved_j).max()) <= LR * (1 + 1e-3) + 1e-7
        n_apart += int((np.abs(moved_t - moved_j) > 1e-3 * LR + 1e-7).sum())
        n_params += g.size
    assert np.sqrt(err2 / ref2) <= 5e-3
    assert n_apart <= 0.05 * n_params
    assert n_params > 30_000_000


def test_loss_decreases_and_freeze_backbone(variables):
    """tests/train/test_step.py's cases on the port: 20 steps on one batch
    at lr 3e-4 (clipnorm 1e6) lower the loss, with num_positive > 0 and a
    finite positive grad_norm; with freeze_backbone the backbone does not
    move while the heads do."""
    model = RetinaNet(1)
    state = create_train_state(model, variables, device="cpu",
                               optimizer=create_optimizer(3e-4, 1e6))
    step = make_train_step(model, num_classes=1)
    batch = _torch_batch(_batch(b=1))
    state, m0 = step(state, batch)
    losses = []
    for _ in range(20):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert int(metrics["num_positive"]) > 0 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < float(m0["loss"])
    assert 0.0 < float(metrics["grad_norm"]) < np.inf
    outputs = make_eval_step(model)(batch["images"])
    assert outputs["classification"].shape[:2] == outputs["regression"].shape[:2]
    assert not outputs["classification"].requires_grad

    model = RetinaNet(1)
    state = create_train_state(model, variables, device="cpu", freeze_backbone=True,
                               optimizer=create_optimizer(1e-2, 1e6))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = make_train_step(model, num_classes=1)(state, batch)
    for n, p in model.named_parameters():
        if n.startswith("backbone."):
            assert torch.equal(p, before[n]), n
    head = "classification_submodel.head.weight"
    assert (model.get_parameter(head) - before[head]).abs().max() > 0
    assert model.backbone.conv1.weight.grad is not None  # in grad_norm


def test_stem_bwd_switch_and_routes(variables, monkeypatch):
    """TDNET_STEM_BWD: unset -> the fused backward, 'remat' -> autograd of
    the reference; an unknown value raises. A shape the fused stem does not
    take (H % 8 != 0) goes through the normalize route."""
    import tdnet_torch.ops.stem_vjp as stem_vjp

    calls = []
    real = stem_vjp.fused_stem_bwd_packed
    monkeypatch.setattr(stem_vjp, "fused_stem_bwd_packed",
                        lambda *a: calls.append(1) or real(*a))
    model = RetinaNet(1)
    state = create_train_state(model, variables, device="cpu")
    step = make_train_step(model, num_classes=1, fused_stem=True)
    batch = _torch_batch(_batch(b=1, packed=True))
    monkeypatch.delenv("TDNET_STEM_BWD", raising=False)
    step(state, batch)
    assert calls == [1]
    monkeypatch.setenv("TDNET_STEM_BWD", "remat")
    _, metrics = step(state, batch)
    assert calls == [1] and np.isfinite(float(metrics["loss"]))
    monkeypatch.setenv("TDNET_STEM_BWD", "xla")
    with pytest.raises(ValueError, match="backward"):
        step(state, batch)
    odd = dict(batch, images=batch["images"][:, :36].contiguous(),
               image_hw=torch.tensor([[36.0, W]]))
    _, metrics = step(state, odd)
    assert calls == [1] and np.isfinite(float(metrics["loss"]))
