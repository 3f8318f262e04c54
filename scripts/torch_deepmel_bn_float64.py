"""How far each package's fp32 gradients of a BatchNorm'd DeepMel lie from
float64's on 4-row shards: the claim behind ``JAX_DEEPMEL`` in
tests/test_torch_parallel.py (the DeepMel that test holds to the JAX
package's sharded step has no BatchNorm).

Run from the repository root on the CPU (about a minute, no card; it
needs the JAX package and the tests' helpers):

    python3 scripts/torch_deepmel_bn_float64.py

Builds the test's data as its ``setup`` fixture does (the fake study at
tests/test_solver.py's tiny width, the first batch of 8 rows, 4 from each
training recording) and the JAX package's solver with the test's small
DeepMel, BatchNorm on (``BASE + DEEPMEL``). On each 4-row shard (the rows
a rank of 2 gets), a local pool each, the train-mode loss's gradient of
the DeepMel's parameters: the JAX package's in fp32 (jax.grad of
``Solver._loss_and_aux``), the port's in fp32 (``Solver.loss_and_grad``)
from the same weights, and the float64 one from the port's fp32-wired
inputs (``deepmel_bn_gradients``), each averaged over the two shards as
the ranks average them. Prints, for each parameter, the largest float64
|gradient| and each package's largest fp32 error against GRAD_ATOL.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import test_torch_parallel as tp_  # noqa: E402
from test_solver import tiny_args  # noqa: E402
from test_torch_epochs import TINY  # noqa: E402

from brainmagick_tpu import train as jtrain  # noqa: E402
from brainmagick_tpu.dataset import SegmentBatch  # noqa: E402
from brainmagick_tpu.env import env as jenv  # noqa: E402
from brainmagick_tpu_torch import train  # noqa: E402


def main() -> None:
    torch.set_num_threads(2)
    tmp = Path(tempfile.mkdtemp(prefix="deepmel_bn_"))
    cache = tmp / "fake_cache"
    cache.mkdir()
    with jenv.temporary(cache=cache):
        jargs = jtrain.parse_overrides(tp_.BASE + tp_.DEEPMEL,
                                       tiny_args(cache, tmp / "jax"))
        solver = jtrain.get_solver(jargs, training=True)
    state = jax.device_get(solver.state)
    dsets = solver.datasets.train.datasets
    shards = [SegmentBatch.collate([d[i] for i in range(4)]) for d in dsets]
    args = train.parse_overrides(
        TINY + ["device=cpu", f"cache={cache}", f"out_dir={tmp / 'port'}",
                *tp_.BASE, *tp_.DEEPMEL])
    widths = tp_._widths(solver)
    trainer = tp_._port_trainer(args, widths, {
        k: np.asarray(v) for k, v in solver.norm_arrays.items()},
        state["params"], state["batch_stats"])

    def jax_loss(params, arrays):
        pad = jax.numpy.ones(len(arrays["meg"]), jax.numpy.float32)
        loss, _ = solver._loss_and_aux(
            params, state["batch_stats"], arrays, solver.norm_arrays, pad,
            None, None, jax.random.PRNGKey(0), True, False)
        return loss

    grad = jax.jit(jax.grad(jax_loss))
    sums: list = [{}, {}, {}]
    for shard in shards:
        arrays = {name: np.asarray(getattr(shard, name))
                  for name in SegmentBatch.ARRAY_FIELDS}
        jax_fm = tp_._jax_as_port(trainer, jax.device_get(grad(
            state["params"], shard.to_device())), grads=True)
        jax_fm = {k[len("fm."):]: torch.from_numpy(np.array(v))
                  for k, v in jax_fm.items() if k.startswith("fm.")}
        port, f64 = tp_.deepmel_bn_gradients(
            trainer, tp_.types.SimpleNamespace(**arrays))
        for total, grads in zip(sums, (jax_fm, port, f64)):
            for key, value in grads.items():
                total[key] = total.get(key, 0) + value.double() / 2
    jax_fm, port, f64 = sums
    print(f"DeepMel (BatchNorm) gradients on {len(shards)} shards of "
          f"{len(shards[0].meg)} rows, fp32 against float64 (GRAD_ATOL "
          f"{tp_.GRAD_ATOL:.0e}):")
    print(f"{'parameter':<28} {'max |g64|':>10} {'JAX fp32':>10} "
          f"{'port fp32':>10}")
    worst = {"JAX": 0., "port": 0.}
    for key in sorted(f64):
        errs = {name: float((g[key] - f64[key]).abs().max())
                for name, g in (("JAX", jax_fm), ("port", port))}
        for name in worst:
            worst[name] = max(worst[name], errs[name])
        print(f"{key:<28} {float(f64[key].abs().max()):>10.3e} "
              f"{errs['JAX']:>10.3e} {errs['port']:>10.3e}")
    print("largest error: " + ", ".join(
        f"{name} {value:.3e} ({'within' if value <= tp_.GRAD_ATOL else 'past'}"
        f" GRAD_ATOL)" for name, value in worst.items()))


if __name__ == "__main__":
    main()
