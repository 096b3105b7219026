"""Bit packing (1/2/4-bit): numpy host versions and torch tensor versions.

Counterpart of genozip_tpu/ops/pack.py: values are packed little-endian
within each byte (value i occupies bits [(i*w) % 8, (i*w) % 8 + w) of byte
(i*w)//8). `pack_np`/`unpack_np` run on the host; `pack_torch`/
`unpack_torch` are the counterparts of its `pack_jnp`/`unpack_jnp` (XLA
elementwise ops there, torch elementwise ops on the tensor's device here),
equal to them on every uint8 input: a value of 2^width or more is shifted
within its byte and the shifted values are summed, mod 256, where
`pack_np` ORs them. Nothing on a CLI path calls the tensor versions, in
either package.
"""

import numpy as np
import torch

ACGT = np.frombuffer(b"ACGT", np.uint8)
# base -> 2-bit code; non-ACGT maps to 0 (exception channel carries the truth)
BASE2BIT = np.zeros(256, dtype=np.uint8)
BASE2BIT[ord("C")] = 1
BASE2BIT[ord("G")] = 2
BASE2BIT[ord("T")] = 3
IS_ACGT = np.zeros(256, dtype=bool)
IS_ACGT[ACGT] = True


def pack_np(vals: np.ndarray, width: int) -> np.ndarray:
    """Pack uint8 values < 2**width into bytes, little-endian bit order."""
    assert width in (1, 2, 4)
    per = 8 // width
    n = vals.shape[0]
    pad = (-n) % per
    if pad:
        vals = np.concatenate([vals, np.zeros(pad, np.uint8)])
    v = vals.reshape(-1, per)
    out = v[:, 0].copy()
    for i in range(1, per):                      # in-place OR: no uint16 temp
        out |= v[:, i] << np.uint8(i * width)
    return out


def unpack_np(packed: np.ndarray, width: int, n: int) -> np.ndarray:
    per = 8 // width
    mask = np.uint8((1 << width) - 1)
    out = np.empty((packed.shape[0], per), np.uint8)
    for i in range(per):
        np.right_shift(packed, np.uint8(i * width), out=out[:, i])
    out &= mask
    return out.reshape(-1)[:n]


def pack_torch(vals: torch.Tensor, width: int) -> torch.Tensor:
    """`pack_jnp`: uint8 values (1-D) -> packed bytes on their device."""
    if width not in (1, 2, 4):
        raise ValueError(f"width {width}")
    per = 8 // width
    pad = (-vals.shape[0]) % per
    v = torch.cat([vals, vals.new_zeros(pad)]).to(torch.int32).view(-1, per)
    shifts = torch.arange(per, dtype=torch.int32, device=vals.device) * width
    return (((v << shifts) & 0xFF).sum(1) & 0xFF).to(torch.uint8)


def unpack_torch(packed: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """`unpack_jnp`: packed bytes -> the first n values, uint8, on their
    device."""
    if width not in (1, 2, 4):
        raise ValueError(f"width {width}")
    per = 8 // width
    shifts = torch.arange(per, dtype=torch.int32, device=packed.device) * \
        width
    v = (packed.to(torch.int32)[:, None] >> shifts[None, :]) & \
        ((1 << width) - 1)
    return v.reshape(-1)[:n].to(torch.uint8)


def seq_pack_2bit(seq: np.ndarray):
    """DNA sequence -> (packed 2-bit codes, exception positions, exception bytes).
    Reference parity: src/codec_acgt.c (ACGT + NONREF_X exception channel)."""
    codes = BASE2BIT[seq]
    exc_mask = ~IS_ACGT[seq]
    exc_pos = np.nonzero(exc_mask)[0].astype(np.uint32)
    exc_bytes = seq[exc_mask]
    return pack_np(codes, 2), exc_pos, exc_bytes


def seq_unpack_2bit(packed: np.ndarray, n: int, exc_pos: np.ndarray, exc_bytes: np.ndarray):
    codes = unpack_np(packed, 2, n)
    seq = ACGT[codes]
    if exc_pos.shape[0]:
        seq[exc_pos] = exc_bytes
    return seq
