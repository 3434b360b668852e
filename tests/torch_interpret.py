"""How the port's tests run the JAX package's Pallas kernels on the CPU.

`interpret(fn, *arrays)` runs `fn(*arrays)`, a JAX function that reaches
Pallas kernels, jitted and in Pallas interpret mode, and waits for its
result. One dispatch matters: an interpret-mode kernel's callbacks dispatch
JAX ops of their own while the computation runs, and a JAX op that the
main thread enqueues meanwhile (as an unjitted chain of kernels and glue
does) can deadlock the CPU client. Non-array arguments go into `fn` as
closed-over constants.

`once(key, fn)` is `fn()` computed once per `key` in a process: the JAX
reference of parametrised cases that differ only in the port's route.
"""

import jax
from jax.experimental.pallas import tpu as pltpu


def interpret(fn, *arrays):
    with pltpu.force_tpu_interpret_mode():
        return jax.block_until_ready(jax.jit(fn)(*arrays))


_RESULTS = {}


def once(key, fn):
    if key not in _RESULTS:
        _RESULTS[key] = fn()
    return _RESULTS[key]
