"""Gradient parity of one ResNet-50 RetinaNet train step on the CPU: tdnet
(JAX, f32) and tdnet_torch (f32) against each other and against an f64 run
of tdnet_torch, on the float batch and variables of
tests/test_torch_train.py.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/torch_grad_parity.py [--threads N]

``--threads`` (default 1, as in the tests) sets torch's CPU threads: the
summation order, and so which ReLUs flip, depends on it.

Prints one JSON line per tensor that differs from the f64 run by more than
1e-3 relative Frobenius on either side, then a summary line: the metrics'
relative differences, the worst tensor between the two f32 runs, the whole
gradient's error, and the share of parameters whose first clipped-Adam step
differs by more than 1e-3 * lr + 1e-7 between the two frameworks.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tdnet_torch.models.retinanet import RetinaNet
from tdnet_torch.train.step import create_train_state, make_train_step
from tdnet_torch.weights import random_variables, variables_from_torch_state
from tests.test_torch_train import (CLIPNORM, LR, _batch, _GrabAdam, _jax_step,
                                    _leaves, _port_step, _torch_batch)


def _f64_grads(variables, batch):
    model = RetinaNet(1, dtype=torch.float64, output_dtype=torch.float64)
    state = create_train_state(
        model, variables, device="cpu",
        optimizer=lambda p: _GrabAdam(p, lr=LR, clipnorm=CLIPNORM))
    model.double()
    tb = _torch_batch(batch)
    tb["images"] = tb["images"].double()
    state, _ = make_train_step(model, num_classes=1)(state, tb)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    raw = dict(zip(names, [g.float() for g in state.optimizer.raw]))
    return dict(_leaves(variables_from_torch_state(raw)["params"]))


def main() -> None:
    variables = random_variables(1, "resnet50", seed=0)
    batch = _batch()
    jm, jg, jp = _jax_step(variables, batch)
    tm, tg, tp, _ = _port_step(variables, batch, fused_stem=False)
    ref = _f64_grads(variables, batch)
    tg, tp, jp = dict(_leaves(tg)), dict(_leaves(tp)), dict(_leaves(jp))
    before = dict(_leaves(variables["params"]))
    rel = lambda a, b: float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    worst, err2, ref2, apart, n = ("", 0.0), 0.0, 0.0, 0, 0
    for path, g in _leaves(jg):
        if path not in tg or not np.any(g):
            continue
        name = "/".join(path)
        r_jax, r_port, r_pair = rel(g, ref[path]), rel(tg[path], ref[path]), rel(tg[path], g)
        if max(r_jax, r_port) > 1e-3:
            print(json.dumps({"tensor": name, "jax_vs_f64": r_jax,
                              "port_vs_f64": r_port, "port_vs_jax": r_pair}))
        worst = max(worst, (name, r_pair), key=lambda t: t[1])
        err2 += float(((tg[path] - g).astype(np.float64) ** 2).sum())
        ref2 += float((g.astype(np.float64) ** 2).sum())
        moved = (tp[path] - before[path]) - (jp[path] - before[path])
        apart += int((np.abs(moved) > 1e-3 * LR + 1e-7).sum())
        n += g.size
    print(json.dumps({
        "metrics_rel": {k: abs(float(tm[k]) - float(jm[k])) / abs(float(jm[k]))
                        for k in ("loss", "classification_loss",
                                  "regression_loss", "grad_norm")},
        "num_positive": [int(tm["num_positive"]), int(jm["num_positive"])],
        "worst_tensor_port_vs_jax": worst,
        "whole_gradient_port_vs_jax": float(np.sqrt(err2 / ref2)),
        "adam_step_apart_share": apart / n}))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--threads", type=int, default=1)
    torch.set_num_threads(parser.parse_args().threads)
    main()
