"""Multi-device paths: `zip --dp` (zip_sharded), `piz_file_dp`
(piz_sharded), `zip --mesh` (mesh_aligner over the seed aligner kernel),
`zip --hosts` (multihost, over torch.distributed) and the flagship encode
step (flagship). Counterpart of genozip_tpu/parallel/."""

from concurrent.futures import ThreadPoolExecutor

import torch


def devices_for(n: int | None = None, devices=None) -> list:
    """The devices of a multi-device path. An explicit `devices` list is
    taken as given (its first `n` when `n` is given); it may name one card
    more than once. Otherwise the kernels' device (`codecs.device()`) says
    where: on the CPU, `n` CPU devices (the kernels' plain versions); on
    CUDA, or when no device is set, min(n, cards present)."""
    if devices is not None:
        devs = [torch.device(d) for d in devices][:n or None]
        if not devs:
            raise ValueError("no devices given")
        return devs
    from .. import codecs
    base = codecs.device()
    if base is not None and base.type == "cpu":
        return [torch.device("cpu")] * max(n or 1, 1)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU is available: pass devices=['cpu'] "
                           "* N, or --device cpu")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(min(n or count, count))]


def split_blocks(n: int, D: int) -> list:
    """n rows in D contiguous blocks, the first n % D one row longer:
    [(start, end)] per block, empty blocks included."""
    q, rem = divmod(n, D)
    out, at = [], 0
    for d in range(D):
        k = q + (d < rem)
        out.append((at, at + k))
        at += k
    return out


def map_devices(fn, jobs) -> list:
    """fn over `jobs` (one a device block), on a thread each when there is
    more than one, so that the devices' launches and copies overlap;
    results in order."""
    if len(jobs) <= 1:
        return [fn(j) for j in jobs]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        return list(pool.map(fn, jobs))


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `t` (the same shape on each), concatenated along the
    first axis in rank order (torch.distributed all_gather over `group`, the
    default group when None)."""
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)
