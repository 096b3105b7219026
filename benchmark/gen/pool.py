"""The generators' parts made on worker processes, in order.

A part (a FASTQ block, a BAM window) depends only on the seed and its index,
so it is made on any process and the file is the same whatever their
number. The workers are forked: the harness makes its inputs in a process
of their own (`python -m benchmark.gen`), which holds no CUDA context and
no thread when they are.
"""

import multiprocessing
import os
from collections import deque
from concurrent.futures import ProcessPoolExecutor

WORKERS = min(8, os.cpu_count() or 1)


def parts(fn, args_of, wanted=None, ahead: int | None = None):
    """Yield fn(*args_of(0)), fn(*args_of(1)), ... in order, made up to
    `ahead` (default: two more than the workers) in advance, and no more
    than `wanted()` (the parts the caller still expects to need after
    those yielded, or None while it cannot tell) in advance. The caller
    stops when it has enough and closes the generator: the parts still
    queued are cancelled and the workers ended before that returns."""
    ahead = ahead or WORKERS + 2
    pool = ProcessPoolExecutor(WORKERS,
                               mp_context=multiprocessing.get_context("fork"))
    todo, i = deque(), 0
    try:
        while True:
            want = wanted() if wanted else None
            limit = ahead if want is None else max(1, min(ahead, want))
            while len(todo) < limit:
                todo.append(pool.submit(fn, *args_of(i)))
                i += 1
            yield todo.popleft().result()
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
