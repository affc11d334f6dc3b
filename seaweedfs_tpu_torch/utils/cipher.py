"""Chunk encryption: AES-256-GCM with a random per-chunk key.

Counterpart of `seaweedfs_tpu/utils/cipher.py`.  The reference's scheme
(weed/util/cipher.go): `encrypt` draws a fresh 256-bit key per chunk,
seals with AES-GCM, and prepends the random 12-byte nonce to the
ciphertext (Go's `gcm.Seal(nonce, nonce, ...)` layout), so
`sealed = nonce || ciphertext || tag`.  The per-chunk key rides in the
chunk metadata (the filer entry), never on the volume server.

The AES and GHASH cores are the port's own g++ library
(csrc/aes_gcm.cc, AES-NI where CPUID finds it), built at first use.  A
library that does not build raises RuntimeError with the compiler's
output; there is no other path.  No torch is loaded.
"""

from __future__ import annotations

import secrets

from seaweedfs_tpu_torch import native

KEY_SIZE = 32
NONCE_SIZE = 12
TAG_SIZE = 16


class CipherError(Exception):
    pass


def gen_cipher_key() -> bytes:
    return secrets.token_bytes(KEY_SIZE)


def encrypt(plaintext: bytes, key: bytes | None = None
            ) -> tuple[bytes, bytes]:
    """(cipher_key, nonce || ciphertext || tag)."""
    key = key or gen_cipher_key()
    nonce = secrets.token_bytes(NONCE_SIZE)
    return key, nonce + native.aes256_gcm_seal(key, nonce, plaintext)


def decrypt(key: bytes, sealed: bytes) -> bytes:
    if len(sealed) < NONCE_SIZE + TAG_SIZE:
        raise CipherError("sealed data too short")
    nonce, body = sealed[:NONCE_SIZE], sealed[NONCE_SIZE:]
    try:
        return native.aes256_gcm_open(key, nonce, body)
    except ValueError as e:
        raise CipherError(str(e)) from e
