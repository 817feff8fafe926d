"""A CPU rehearsal of the decompositions of the port's NMS kernels, in torch
int64 and float32, held exactly against the plain versions and the JAX
package.

B2 (``csrc/nms.cu``) builds an IoU bitmask, one 64-bit word per box i and
64-box block of later boxes j (bit b: i valid, j = 64 w + b > i, j < K,
IoU(i, j) > thr, in the kernel's operation order), then scans each row in
64-box chunks: the chunk is resolved box by box in rank order from its
diagonal words (kept iff valid and not removed; a kept box's word, with its
own bit, leaves the set still to decide), and each kept box's words for
later chunks are ORed into the removed words. Held against ``nms_keep_plain`` and
``tdnet.ops.pallas_nms.pallas_nms_keep`` / ``pallas_nms_keep_rows`` in
interpret mode (K padded to 128 with invalid slots there).

B5 (``csrc/soft_nms.cu``) makes each pick with one barrier: every thread
(one a candidate, 32 a warp) forms an order-preserving key of its remaining
score; each warp takes the maximum key and its lowest lane; every warp
then reduces the warps' slots, lowest warp first on ties. Held against
``soft_nms_rescore_plain`` exactly, and against
``tdnet.ops.soft_nms.soft_nms_rescore``: the selections exactly, the
scores within rtol 1e-5 / atol 1e-6 (the reference's own bound between its
two forms; XLA computes the IoU matrix and exp in its own fused loops,
which round the decayed scores differently by about an ulp).

Inputs: K of 1024, 200 (ragged) and 64; rows of clustered boxes with
scattered invalid slots, an invalid tail (100 slots, K // 2 at K 64), an
all-invalid row and a row of 16 boxes (and scores) repeated exactly. Two
controls must fail: a scan without the resolution inside a chunk, and a key
that breaks ties toward the higher index.
"""

import ctypes
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdnet_torch.ops.nms_kernel import nms_keep_plain
from tdnet_torch.ops.soft_nms import soft_nms_rescore_plain

torch.set_num_threads(1)  # tier-1 runs several xdist workers

KS = (1024, 200, 64)
CHUNK = 64
U64 = (1 << 64) - 1
NMS_THR = 0.5
SOFT_KW = dict(sigma=0.5, iou_threshold=0.3, score_threshold=0.001,
               max_selections=300)


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_executables():
    yield
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:  # not glibc: nothing to trim
        pass


def _rows(k):
    """(boxes (4, k, 4), valid (4, k), scores (4, k)) float32 / bool:
    clustered boxes with 10% invalid slots; the same with an invalid tail;
    all invalid; 16 boxes and scores repeated exactly (all valid). Scores
    are sorted descending and 0 where invalid."""
    rng = np.random.RandomState(k)
    centres = rng.uniform(0, 200, (4, 6, 2))
    pick = rng.randint(0, 6, (4, k))
    c = np.take_along_axis(centres, pick[..., None], axis=1) + rng.normal(0, 8, (4, k, 2))
    wh = rng.uniform(10, 60, (4, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.05, 1.0, (4, k)), axis=1)[:, ::-1].astype(np.float32)
    valid = rng.uniform(size=(4, k)) > 0.1
    valid[1] = True
    valid[1, -min(100, k // 2):] = False
    valid[2] = False
    boxes[3] = np.tile(boxes[3, :16], (-(-k // 16), 1))[:k]
    scores[3] = np.tile(scores[3, :16], -(-k // 16))[:k]
    valid[3] = True
    scores = np.where(valid, scores, 0.0).astype(np.float32)
    return boxes, valid, np.ascontiguousarray(scores)


@pytest.fixture(scope="module")
def jax_nms():
    """{(kernel, K): keep} from the Pallas NMS kernels in interpret mode."""
    import tdnet.ops.pallas_nms as pn

    out = {}
    for k in KS:
        boxes, valid, _ = _rows(k)
        pad = -k % 128
        b = jnp.asarray(np.pad(boxes, ((0, 0), (0, pad), (0, 0))))
        v = jnp.asarray(np.pad(valid, ((0, 0), (0, pad))))
        for name in ("pallas_nms_keep", "pallas_nms_keep_rows"):
            keep = getattr(pn, name)(b, v, iou_threshold=NMS_THR, interpret=True)
            out[name, k] = np.asarray(keep)[:, :k]
    return out


@pytest.fixture(scope="module")
def jax_soft():
    """{(method, K): rescored} from the reference's soft_nms_rescore."""
    from tdnet.ops.soft_nms import soft_nms_rescore

    out = {}
    for k in KS:
        boxes, _, scores = _rows(k)
        for method in ("gaussian", "linear"):
            fn = jax.vmap(lambda b, s: soft_nms_rescore(b, s, method=method, **SOFT_KW))
            out[method, k] = np.asarray(fn(jnp.asarray(boxes), jnp.asarray(scores)))
    return out


# ---------------------------------------------------------------- B2


def _iou_words(boxes, valid, thr):
    """Pass 1: (R, K, W) int64 words, W = ceil(K / 64), the IoU in the
    kernel's order: iw, ih clamped at 0, inter = iw * ih, union =
    (area_i + area_j) - inter, IoU 0 where union <= 0."""
    r, k, _ = boxes.shape
    words = -(-k // CHUNK)
    x1, y1, x2, y2 = (t[:, :, None] for t in boxes.unbind(-1))  # i
    u1, v1, u2, v2 = (t[:, None, :] for t in boxes.unbind(-1))  # j
    area_i, area_j = (x2 - x1) * (y2 - y1), (u2 - u1) * (v2 - v1)
    iw = (torch.minimum(x2, u2) - torch.maximum(x1, u1)).clamp_min(0.0)
    ih = (torch.minimum(y2, v2) - torch.maximum(y1, v1)).clamp_min(0.0)
    inter = iw * ih
    union = (area_i + area_j) - inter
    iou = torch.where(union > 0, inter / union, torch.zeros_like(union))
    idx = torch.arange(k)
    bits = (iou > torch.tensor(thr)) & (idx[None, :] > idx[:, None]) & valid[:, :, None]
    bits = torch.nn.functional.pad(bits, (0, words * CHUNK - k))
    weights = torch.ones(CHUNK, dtype=torch.int64) << torch.arange(CHUNK)
    return (bits.view(r, k, words, CHUNK).to(torch.int64) * weights).sum(-1)


def _scan(mask, valid, resolve=True):
    """Pass 2: each row in 64-box chunks, as one warp walks it. With
    `resolve` False (the control), a chunk keeps every valid box that
    earlier chunks did not remove."""
    r, k, words = mask.shape
    keep = torch.zeros((r, k), dtype=torch.bool)
    for row in range(r):
        removed = torch.zeros(words, dtype=torch.int64)  # lane-held words
        for c in range(words):
            i0 = c * CHUNK
            n = min(CHUNK, k - i0)
            diag = [int(w) & U64 for w in mask[row, i0:i0 + n, c]]
            vbits = sum(1 << b for b in range(n) if valid[row, i0 + b])
            todo = vbits & ~(int(removed[c]) & U64)
            if not resolve:
                kept = todo
            else:  # the diagonal word with the box's own bit
                kept = 0
                while todo:
                    b = (todo & -todo).bit_length() - 1
                    kept |= 1 << b
                    todo &= ~(diag[b] | 1 << b)
            keep[row, i0:i0 + n] = torch.tensor([bool(kept >> b & 1) for b in range(n)])
            for b in range(n):
                if kept >> b & 1:
                    removed[c + 1:] |= mask[row, i0 + b, c + 1:]
    return keep


@pytest.mark.parametrize("k", KS)
def test_nms_bitmask_scan_equals_plain_and_pallas(k, jax_nms):
    boxes, valid, _ = _rows(k)
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    got = _scan(_iou_words(b, v, NMS_THR), v)
    want = nms_keep_plain(b, v, NMS_THR)
    assert torch.equal(got, want)
    for name in ("pallas_nms_keep", "pallas_nms_keep_rows"):
        np.testing.assert_array_equal(got.numpy(), jax_nms[name, k])
    # something kept and something suppressed in the clustered rows; all
    # invalid keeps nothing; the repeated row keeps no more than 16 boxes
    for row in (0, 1):
        assert 0 < int(want[row].sum()) < int(v[row].sum())
    assert not want[2].any()
    assert 0 < int(want[3].sum()) <= 16 and not want[3, 16:].any()


@pytest.mark.parametrize("k", KS)
def test_nms_scan_without_chunk_resolution_fails(k):
    boxes, valid, _ = _rows(k)
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    got = _scan(_iou_words(b, v, NMS_THR), v, resolve=False)
    assert not torch.equal(got, nms_keep_plain(b, v, NMS_THR))


# ---------------------------------------------------------------- B5


def _key(v):
    """The kernel's order-preserving key of a float32 score, as int64 in
    [0, 2^32): larger score, larger key; -0 and +0 share one."""
    v = torch.where(v == 0, torch.zeros_like(v), v)
    u = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, ~u & 0xFFFFFFFF, u | 1 << 31)


def _unkey(key):
    u = torch.where(key >= 1 << 31, key & 0x7FFFFFFF, ~key & 0xFFFFFFFF)
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)  # as a signed 32-bit word
    return u.to(torch.int32).view(torch.float32)


def _first(hit, lowest=True):
    """Index of the first (or, for the control, last) True along the last
    dimension."""
    n = hit.shape[-1]
    if lowest:
        return hit.to(torch.int8).argmax(-1)
    return n - 1 - hit.flip(-1).to(torch.int8).argmax(-1)


def _soft_picks(boxes, scores, method, sigma, iou_threshold, score_threshold,
                max_selections, lowest=True):
    """One thread a candidate, 32 a warp; each pick is the warps' keys and
    lowest lanes, then every warp's reduce of their slots."""
    r, k = scores.shape
    threads = -(-k // 32) * 32
    pad = threads - k
    neg_inf = torch.tensor(float("-inf"))
    rem = torch.where(scores > score_threshold, scores, neg_inf)
    picked = torch.zeros_like(scores)
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    sigma_t = torch.tensor(sigma, dtype=torch.float32)
    lanes = torch.arange(threads).view(-1, 32)
    done = torch.zeros(r, dtype=torch.bool)
    rows = torch.arange(r)
    for _ in range(min(max_selections, k)):
        key = torch.nn.functional.pad(_key(rem), (0, pad))  # padding: key 0
        key = key.view(r, -1, 32)
        wmax = key.max(-1).values  # (R, warps): the warps' slots
        wsel = lanes[None].expand(r, -1, -1).gather(
            2, _first(key == wmax[..., None], lowest)[..., None])[..., 0]
        top = wmax.max(-1).values
        sel = wsel.gather(1, _first(wmax == top[:, None], lowest)[:, None])[:, 0]
        done |= ~(_unkey(top) > score_threshold)
        live = ~done
        is_sel = torch.arange(k)[None, :] == sel[:, None]
        pick = boxes[rows, sel][:, :, None]  # (R, 4, 1)
        iw = (torch.minimum(x2, pick[:, 2]) - torch.maximum(x1, pick[:, 0])).clamp_min(0.0)
        ih = (torch.minimum(y2, pick[:, 3]) - torch.maximum(y1, pick[:, 1])).clamp_min(0.0)
        inter = iw * ih
        union = (area + area[rows, sel][:, None]) - inter
        iou = torch.where(union > 0, inter / union, torch.zeros_like(union))
        if method == "gaussian":
            decay = torch.exp(torch.div(-(iou * iou), sigma_t))
        else:
            decay = torch.where(iou > iou_threshold, 1.0 - iou, torch.ones_like(iou))
        decayed = torch.where(rem != neg_inf, rem * decay, rem)
        picked = torch.where(live[:, None] & is_sel, rem, picked)
        rem = torch.where(live[:, None], torch.where(is_sel, neg_inf, decayed), rem)
        if bool(done.all()):
            break
    return picked


def test_key_orders_scores():
    v = torch.tensor([float("-inf"), -2.5, -1e-30, -0.0, 0.0, 1e-38, 1e-30,
                      0.001, 0.5, 1.0, 3.0e38], dtype=torch.float32)
    key = _key(v)
    assert bool((key[1:] >= key[:-1]).all()) and int(key[3]) == int(key[4])
    assert int(key.min()) > 0  # above the padding's key
    assert torch.equal(_unkey(key)[4:], v[4:]) and torch.equal(_unkey(key)[:3], v[:3])


@pytest.mark.parametrize("method", ["gaussian", "linear"])
@pytest.mark.parametrize("k", KS)
def test_soft_one_barrier_pick_equals_plain_and_reference(k, method, jax_soft):
    boxes, _, scores = _rows(k)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    kw = dict(method=method, **SOFT_KW)
    got = _soft_picks(b, s, **kw)
    want = soft_nms_rescore_plain(b, s, **kw)
    assert torch.equal(got, want)
    ref = jax_soft[method, k]
    np.testing.assert_array_equal(got.numpy() > 0, ref > 0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert not got[2].any()  # the all-invalid row picks nothing
    # the repeated row: of each tie the lowest index is picked first
    assert float(got[3, 0]) == float(s[3, 0]) and float(got[3, 16]) < float(got[3, 0])


@pytest.mark.parametrize("k", KS)
def test_soft_key_toward_higher_index_fails(k):
    boxes, _, scores = _rows(k)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    kw = dict(method="gaussian", **SOFT_KW)
    got = _soft_picks(b, s, lowest=False, **kw)
    assert not torch.equal(got, soft_nms_rescore_plain(b, s, **kw))
