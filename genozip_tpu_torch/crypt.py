"""Archive encryption: AES-256-CTR over compressed section payloads.

Counterpart of genozip_tpu/crypt.py, with the same key, tag, counter and
keystream, so each package reads the other's encrypted archives. key =
PBKDF2-HMAC-SHA256(password, salt, 200k); the plaintext FILE_HEADER carries
the salt and an 8-byte key-verification tag; every other section's
compressed payload is CTR-encrypted with counter0 = salt[:8] ||
section_offset (unique per section, since offsets grow by more than a
section's block count). The section adler is over the plaintext compressed
bytes, so a wrong key fails at the digest check. The keystream is the
`aes256_ctr` kernel on the device that `codecs.enable_device_rans` set
(ops/aes_cuda.py), or its plain version on the CPU.

Reference parity: src/crypt.c (crypt_do :118) / src/aes.c.
"""

import hashlib
import os

from .ops.aes_cuda import aes256_ctr

FLAG_ENCRYPTED = 2


def derive_key(password: str, salt: bytes) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", password.encode(), salt, 200_000)


def key_tag(key: bytes) -> str:
    return hashlib.sha256(b"gxz-verify" + key).hexdigest()[:16]


def new_salt() -> bytes:
    return os.urandom(16)


def counter0(salt: bytes, offset: int) -> bytes:
    return salt[:8] + offset.to_bytes(8, "little")


def crypt_payload(key: bytes, salt: bytes, offset: int, data,
                  device=None) -> bytes:
    """Encrypt or decrypt (the same XOR) one section payload at file offset
    `offset`, on `device` (None: the CPU)."""
    return aes256_ctr(key, counter0(salt, offset), data, device)
