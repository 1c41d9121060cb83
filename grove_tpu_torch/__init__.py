"""grove_tpu_torch — the PyTorch/CUDA port of grove_tpu.

It runs the bench's main path — expand the backlog, build the snapshot, plan
and encode waves, solve each wave on an NVIDIA Hopper card with one
hand-written CUDA kernel launch, harvest once, decode the bindings — and the
serving path (orchestrator/controller.py under sim/simulator.py), and
imports nothing of JAX or of the grove_tpu package. The modules keep the JAX
package's names so each has a findable counterpart:

  api/, state/, orchestrator/, sim/,  host model and serving path, copied
  tenancy/, initc/
  runtime/, api/admission.py,         the operator binary: python -m
  api/webhook.py, cluster/            grove_tpu_torch.runtime (Manager,
                                      admission webhooks, KWOK/watch source)
  solver/encode.py                    GangBatch + encode_gangs
  solver/reference.py                 plain PyTorch versions of the solve
  kernels/                            the CUDA kernel, its builder and wrapper
  solver/core.py, solver/drain.py     solve_batch / drain_backlog entry points
  convert.py                          the JAX package's arrays -> the port's
  bench.py                            python -m grove_tpu_torch.bench
"""

from grove_tpu_torch.version import VERSION as __version__  # noqa: E402,F401
