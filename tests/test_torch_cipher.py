"""The port's chunk cipher (`seaweedfs_tpu_torch/utils/cipher.py` over
csrc/aes_gcm.cc) and tiered chunk cache (`utils/chunk_cache.py`): twins
of the reference's tests, the port's seal held against the reference's
native seal and `cryptography`'s AES-GCM byte for byte, known answers,
and a fresh interpreter showing the filer, the cache and the cipher load
neither torch nor jax nor the reference package."""

import os
import secrets
import subprocess
import sys
import time

import numpy as np
import pytest

from seaweedfs_tpu import native as ref_native
from seaweedfs_tpu.utils import cipher as ref_cipher
from seaweedfs_tpu_torch import native
from seaweedfs_tpu_torch.utils import cipher
from seaweedfs_tpu_torch.utils.chunk_cache import ChunkCache, DiskTier

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---- twins of the reference's tests --------------------------------------

def test_chunk_cache_tiers(tmp_path):
    c = ChunkCache(mem_limit=1000, disk_dir=str(tmp_path / "cc"),
                   disk_limit=100_000)
    small, big = b"a" * 100, b"b" * 5000
    c.put("s", small)
    c.put("b", big)  # too big for mem, lands on disk
    assert c.get("s") == small
    assert c.get("b") == big
    # mem eviction: fill past the mem limit, disk still serves
    for i in range(20):
        c.put(f"k{i}", b"x" * 200)
    assert c.get("s") == small  # from disk tier
    assert c.misses == 0 or c.hits > 0


def test_chunk_cache_disk_eviction(tmp_path):
    t = DiskTier(str(tmp_path / "t"), limit_bytes=1000)
    for i in range(10):
        t.put(f"k{i}", b"z" * 300)
        time.sleep(0.01)
    # total would be 3000 > 1000: oldest evicted, newest kept
    assert t.get("k9") is not None
    assert t.get("k0") is None


def test_cipher_roundtrip_and_tamper():
    msg = secrets.token_bytes(100_000)
    key, sealed = cipher.encrypt(msg)
    assert cipher.decrypt(key, sealed) == msg
    bad = bytearray(sealed)
    bad[20] ^= 1
    with pytest.raises(cipher.CipherError):
        cipher.decrypt(key, bytes(bad))


# ---- the cache beside the reference's ------------------------------------

def test_chunk_cache_tiers_and_counters_equal_reference(tmp_path):
    """The same puts and gets give the same hits, misses, bytes per tier
    and files per tier in both packages' caches."""
    from seaweedfs_tpu.utils.chunk_cache import ChunkCache as RefCache
    rng = np.random.default_rng(7)
    sizes = rng.integers(1, 6 << 20, 40).tolist()
    ops = rng.integers(0, 40, 120).tolist()
    got = []
    for name, cls in (("port", ChunkCache), ("ref", RefCache)):
        c = cls(mem_limit=8 << 20, disk_dir=str(tmp_path / name),
                disk_limit=48 << 20)
        seen = []
        for i in ops:
            key = f"3,{i:x}"
            data = c.get(key)
            if data is None:
                c.put(key, bytes([i % 251]) * sizes[i])
            else:
                assert data == bytes([i % 251]) * sizes[i]
            seen.append(data is not None)
        got.append((seen, c.stats(), [sorted(os.listdir(t.dir))
                                      for t in c.tiers]))
    assert got[0] == got[1]
    assert got[0][1]["hits"] > 0 and got[0][1]["misses"] > 0


# ---- the seal beside the reference's and an independent oracle ----------

def test_known_answers_zero_key_and_nonce():
    key, nonce = bytes(32), bytes(12)
    assert native.aes256_gcm_seal(key, nonce, b"").hex() == \
        "530f8afbc74536b9a963b4f1c4cb738b"
    assert native.aes256_gcm_seal(key, nonce, bytes(16)).hex() == \
        "cea7403d4d606b6e074ec5d3baf39d18" "d0d1c8a799996bf0265b98b5d48ab919"
    assert native.aes256_gcm_open(key, nonce, bytes.fromhex(
        "530f8afbc74536b9a963b4f1c4cb738b")) == b""


@pytest.mark.parametrize("size", [0, 1, 15, 16, 17, 65, 4 << 20])
def test_seal_equals_reference_and_each_opens_the_other(size):
    if not ref_native.available():  # as tests/test_native.py skips
        pytest.skip(f"the reference's native library does not load here: "
                    f"{ref_native.load_error()}")
    rng = np.random.default_rng(size)
    key = rng.bytes(32)
    nonce = rng.bytes(12)
    pt = rng.bytes(size)
    aad = rng.bytes(size % 23)
    sealed = native.aes256_gcm_seal(key, nonce, pt, aad)
    assert sealed == ref_native.aes256_gcm_seal(key, nonce, pt, aad)
    assert len(sealed) == size + 16
    assert ref_native.aes256_gcm_open(key, nonce, sealed, aad) == pt
    assert native.aes256_gcm_open(key, nonce, sealed, aad) == pt
    # the cipher layer's nonce || ciphertext || tag crosses both ways
    k, blob = cipher.encrypt(pt)
    assert ref_cipher.decrypt(k, blob) == pt
    k, blob = ref_cipher.encrypt(pt)
    assert cipher.decrypt(k, blob) == pt


@pytest.mark.parametrize("size", [0, 31, 4096, 1 << 20])
def test_seal_equals_cryptography(size):
    AESGCM = pytest.importorskip(
        "cryptography.hazmat.primitives.ciphers.aead").AESGCM
    key, nonce = secrets.token_bytes(32), secrets.token_bytes(12)
    pt = secrets.token_bytes(size)
    sealed = native.aes256_gcm_seal(key, nonce, pt)
    assert sealed == AESGCM(key).encrypt(nonce, pt, None)
    key2, blob = cipher.encrypt(pt)
    assert AESGCM(key2).decrypt(blob[:12], blob[12:], None) == pt


@pytest.mark.parametrize("where", ["ciphertext", "tag", "nonce", "key"])
def test_open_refuses_any_tampering(where):
    key, blob = cipher.encrypt(b"x" * 1000)
    blob = bytearray(blob)
    if where == "ciphertext":
        blob[500] ^= 0x80
    elif where == "tag":
        blob[-1] ^= 1
    elif where == "nonce":
        blob[0] ^= 1
    else:
        key = bytes([key[0] ^ 1]) + key[1:]
    with pytest.raises(cipher.CipherError):
        cipher.decrypt(key, bytes(blob))
    with pytest.raises(cipher.CipherError, match="too short"):
        cipher.decrypt(key, bytes(27))


def test_bad_key_or_nonce_length_raises():
    with pytest.raises(ValueError):
        native.aes256_gcm_seal(bytes(16), bytes(12), b"x")
    with pytest.raises(ValueError):
        native.aes256_gcm_open(bytes(32), bytes(8), bytes(16))


def test_cipher_library_builds_into_build_dir():
    from seaweedfs_tpu_torch import _build
    lib = _build.load("aes_gcm")
    path = _build.library_path("aes_gcm")
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert lib.wn_aes256_gcm_seal is not None
    # no -march=native: the name means the same code on every host
    assert "-march=native" not in _build._command("aes_gcm", "OUT")


def test_filer_cache_and_cipher_load_no_torch_jax_or_reference():
    code = ("import sys\n"
            "import seaweedfs_tpu_torch.filer\n"
            "from seaweedfs_tpu_torch.filer import filechunk_section, "
            "filechunk_manifest, filer_conf, filer_deletion, stores_extra\n"
            "import seaweedfs_tpu_torch.utils.chunk_cache\n"
            "from seaweedfs_tpu_torch.utils import cipher\n"
            "k, s = cipher.encrypt(b'abc')\n"
            "assert cipher.decrypt(k, s) == b'abc'\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib') or m.startswith('seaweedfs_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)
