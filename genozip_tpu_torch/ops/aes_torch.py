"""AES-256-CTR in plain PyTorch: the plain version of the `aes256_ctr` kernel
(csrc/aes.cu), and the host work both routes share (the key schedule and
the counter split).

The function is genozip_tpu's section encryption (`genozip_tpu/crypt.py`,
native `gxz_aes256_ctr`): FIPS-197 AES-256 of each 16-byte counter block,
XOR-ed into the data; the counter is one 128-bit big-endian integer,
incremented by one a block, mod 2^128. The state is held as four u32 column
words in int64 tensors (`torch.uint32` has no shifts on the CPU), and a
round is the four-T-table form the kernel uses.
"""

import functools

import torch

SBOX = bytes.fromhex(
    "637c777bf26b6fc53001672bfed7ab76ca82c97dfa5947f0add4a2af9ca472c0"
    "b7fd9326363ff7cc34a5e5f171d8311504c723c31896059a071280e2eb27b275"
    "09832c1a1b6e5aa0523bd6b329e32f8453d100ed20fcb15b6acbbe394a4c58cf"
    "d0efaafb434d338545f9027f503c9fa851a3408f929d38f5bcb6da2110fff3d2"
    "cd0c13ec5f974417c4a77e3d645d197360814fdc222a908846eeb814de5e0bdb"
    "e0323a0a4906245cc2d3ac629195e479e7c8376d8dd54ea96c56f4ea657aae08"
    "ba78252e1ca6b4c6e8dd741f4bbd8b8a703eb5664803f60e613557b986c11d9e"
    "e1f8981169d98e949b1e87e9ce5528df8ca1890dbfe6426841992d0fb054bb16")
RCON = (0x00, 0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1b, 0x36)
CHUNK_BLOCKS = 1 << 18     # 4 MiB of data a pass of the plain version


@functools.lru_cache(maxsize=16)
def round_keys(key: bytes) -> tuple:
    """The AES-256 key schedule of a 32-byte key: 60 big-endian u32 words
    (FIPS-197 5.2)."""
    if len(key) != 32:
        raise ValueError(f"AES-256 needs a 32-byte key, got {len(key)}")
    w = [int.from_bytes(key[4 * i:4 * i + 4], "big") for i in range(8)]
    for i in range(8, 60):
        t = w[i - 1]
        if i % 8 == 0:
            t = ((t << 8) | (t >> 24)) & 0xFFFFFFFF
            t = _sub_word(t) ^ (RCON[i // 8] << 24)
        elif i % 8 == 4:
            t = _sub_word(t)
        w.append(w[i - 8] ^ t)
    return tuple(w)


def _sub_word(t: int) -> int:
    return int.from_bytes(bytes(SBOX[b] for b in t.to_bytes(4, "big")), "big")


def split_counter(counter0: bytes) -> tuple:
    """counter0 as (bytes 0-7, bytes 8-15), each a big-endian integer."""
    if len(counter0) != 16:
        raise ValueError(f"counter0 must be 16 bytes, got {len(counter0)}")
    return (int.from_bytes(counter0[:8], "big"),
            int.from_bytes(counter0[8:], "big"))


@functools.lru_cache(maxsize=4)
def _tables(device):
    """T0..T3 (int64, 256 each) and the S-box on `device`: T0[x] is the
    column (2s, s, s, 3s) of s = S[x], Tk its rotation right by 8k bits."""
    s = torch.tensor(list(SBOX), dtype=torch.int64, device=device)
    s2 = ((s << 1) ^ ((s >> 7) * 0x1B)) & 0xFF
    t0 = (s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s)
    ts = [t0]
    for _ in range(3):
        t = ts[-1]
        ts.append(((t >> 8) | (t << 24)) & 0xFFFFFFFF)
    return ts, s


def keystream_words(rk, ctr_hi: int, ctr_lo: int, first: int, count: int,
                    device="cpu") -> torch.Tensor:
    """The keystream of blocks first .. first+count-1 as (count, 4) int64
    big-endian words, computed on `device`."""
    (T0, T1, T2, T3), S = _tables(torch.device(device))
    j = torch.arange(first, first + count, dtype=torch.int64, device=device)
    # counter0 + j over four 32-bit limbs, most significant first
    c = [(ctr_hi >> 32) & 0xFFFFFFFF, ctr_hi & 0xFFFFFFFF,
         (ctr_lo >> 32) & 0xFFFFFFFF, ctr_lo & 0xFFFFFFFF]
    add = [torch.zeros_like(j), torch.zeros_like(j), j >> 32, j & 0xFFFFFFFF]
    st = [None] * 4
    carry = torch.zeros_like(j)
    for k in (3, 2, 1, 0):
        v = add[k] + c[k] + carry
        carry = v >> 32
        st[k] = (v & 0xFFFFFFFF) ^ rk[k]
    for r in range(1, 14):
        st = [T0[st[i] >> 24] ^ T1[(st[(i + 1) % 4] >> 16) & 0xFF] ^
              T2[(st[(i + 2) % 4] >> 8) & 0xFF] ^ T3[st[(i + 3) % 4] & 0xFF] ^
              rk[4 * r + i] for i in range(4)]
    out = [((S[st[i] >> 24] << 24) | (S[(st[(i + 1) % 4] >> 16) & 0xFF] << 16) |
            (S[(st[(i + 2) % 4] >> 8) & 0xFF] << 8) | S[st[(i + 3) % 4] & 0xFF])
           ^ rk[56 + i] for i in range(4)]
    return torch.stack(out, dim=1)


def aes256_ctr_plain(rk, ctr_hi: int, ctr_lo: int,
                     data: torch.Tensor) -> torch.Tensor:
    """XOR the keystream into `data` (uint8, 1-D) in place, on its device;
    returns `data`."""
    n = data.numel()
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64,
                          device=data.device)
    for first in range(0, (n + 15) // 16, CHUNK_BLOCKS):
        count = min(CHUNK_BLOCKS, (n + 15) // 16 - first)
        words = keystream_words(rk, ctr_hi, ctr_lo, first, count, data.device)
        ks = ((words[:, :, None] >> shifts) & 0xFF) \
            .to(torch.uint8).reshape(-1)
        lo, hi = 16 * first, min(n, 16 * (first + count))
        data[lo:hi] ^= ks[:hi - lo]
    return data
