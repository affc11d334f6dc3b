"""The PyTorch/CUDA port's GF(2^8) layer held against the JAX package.

Inputs are made with numpy from fixed seeds and handed to both packages.
GF(2^8) arithmetic is exact, so every comparison is exact equality.  The
port runs here on the CPU, where `CudaGFMatrix` takes its plain version;
the reference's Pallas kernel runs in interpret mode, as
tests/test_pallas.py runs it.
"""

import ast
import itertools
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from seaweedfs_tpu.models import rs as ref_rs
from seaweedfs_tpu.ops import gf as ref_gf
from seaweedfs_tpu.ops import gfmat_jax, pallas_gf

from seaweedfs_tpu_torch.models import rs
from seaweedfs_tpu_torch.ops import codec_base, codecs, dispatch, gf, gf_cuda
from seaweedfs_tpu_torch.storage.ec import ec_files

REPO = pathlib.Path(__file__).resolve().parent.parent


# ---- the port stands alone ---------------------------------------------

def _port_files():
    return sorted((REPO / "seaweedfs_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top != "jax" and top != "jaxlib", f"{path}: imports {name}"
            assert top != "seaweedfs_tpu", f"{path}: imports {name}"
    # the card's path needs none of the servers' packages: none is
    # imported at module level (security/tls.py imports cryptography
    # inside generate_certs, which nothing on the card's path calls);
    # the servers' own modules are the exception, aiohttp being what
    # they serve with
    if path.parent.name == "server":
        return
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in (
                    "aiohttp", "google", "cryptography"), \
                    f"{path}: imports {name} at module level"


def test_import_rule_covers_the_store_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("storage/store.py", "storage/backend.py", "remote_storage.py",
                "storage/volume.py", "storage/needle_map.py",
                "utils/resilience.py", "utils/http.py", "security/tls.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_import_rule_covers_the_server_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("server/volume_server.py", "server/ui.py", "__main__.py",
                "pb/__init__.py", "security/jwt.py", "security/guard.py",
                "utils/weedlog.py", "topology/topology.py", "images.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_import_rule_covers_the_maintenance_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("maintenance/scrub.py", "maintenance/faults.py",
                "ops/fleet_convert.py", "ops/regen.py", "stats/trace.py",
                "stats/metrics.py", "server/volume_server.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_import_rule_covers_the_mesh_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/dryrun.py", "ops/dispatch.py",
                "ops/fleet_convert.py", "ops/codecs.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_import_rule_covers_the_planes_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("stats/aggregate.py", "stats/history.py",
                "stats/interference.py", "stats/canary.py",
                "stats/loops.py", "stats/heat.py", "stats/pipeline.py",
                "utils/fanout.py", "ops/codec_tags.py", "server/master.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_import_rule_covers_the_master_maintenance_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("maintenance/repair.py", "maintenance/convert.py",
                "maintenance/autopilot.py", "utils/hashring.py",
                "utils/resilience.py", "stats/interference.py",
                "stats/metrics.py", "server/master.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_import_rule_covers_the_shell_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("client.py", "utils/vid_cache.py",
                "server/master_follower.py", "shell/__init__.py",
                "shell/commands.py", "shell/shell.py", "ops/codec_tags.py",
                "__main__.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel


def test_import_rule_covers_the_filer_slice():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    for rel in ("filer/__init__.py", "filer/entry.py", "filer/filechunks.py",
                "filer/filechunk_section.py", "filer/filechunk_manifest.py",
                "filer/filerstore.py", "filer/abstract_sql.py",
                "filer/stores_extra.py", "filer/filer_conf.py",
                "filer/filer.py", "filer/filer_deletion.py",
                "utils/chunk_cache.py", "utils/cipher.py", "native.py"):
        assert f"seaweedfs_tpu_torch/{rel}" in files, rel
    assert (REPO / "seaweedfs_tpu_torch/csrc/aes_gcm.cc").exists()


def test_card_path_modules_import_no_server_package():
    """The store, the EC files and the codecs load without aiohttp and
    protobuf: only the server modules import them at module level."""
    code = ("import sys\n"
            "import seaweedfs_tpu_torch.storage.store\n"
            "import seaweedfs_tpu_torch.pb, seaweedfs_tpu_torch.utils.http\n"
            "import seaweedfs_tpu_torch.stats.trace\n"
            "import seaweedfs_tpu_torch.maintenance.scrub\n"
            "import seaweedfs_tpu_torch.maintenance.faults\n"
            "import seaweedfs_tpu_torch.parallel.mesh\n"
            "import seaweedfs_tpu_torch.parallel.dryrun\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('aiohttp', 'jax') or m.startswith('google.protobuf')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)


def test_port_path_leaves_jax_unloaded(tmp_path):
    """Encode through the codec, convert a fleet of two volumes, scrub
    one of them and repair a lost shard of it from a helper's partials,
    then regenerate a lost MSR shard from helper sub-rows, then encode
    with the native host codec and rebuild a shard host-serial, then boot
    a store, vacuum a volume, encode it, mount its shard set, decode it
    back after losing two data shards and tier another volume out, then
    read a needle of that shard set degraded from a loopback peer through
    PooledHTTP, once plainly and once hedged against the peer's delay,
    then run the mesh: the multi-device dry run, an encode and rebuild
    under WEEDTPU_EC_CODEC=mesh and a fleet on a unit mesh, all on the
    CPU, in a fresh interpreter: neither jax nor the reference package
    gets imported."""
    code = ("import os, sys, numpy as np, torch\n"
            "os.environ.pop('WEEDTPU_EC_CODEC', None)\n"
            "from seaweedfs_tpu_torch.storage.ec import ec_files, ec_volume\n"
            "from seaweedfs_tpu_torch.ops import dispatch, fleet_convert, "
            "gf_cuda\n"
            "from seaweedfs_tpu_torch.maintenance import scrub\n"
            "from seaweedfs_tpu_torch.ops import codecs\n"
            "for tag in ('lrc_10_2_2', 'msr_9_16'):\n"
            "    x = codecs.make_codec(tag, device='cpu')\n"
            "    x.encode_parity(torch.zeros((x.k, 64), dtype=torch.uint8))\n"
            "c = gf_cuda.get_codec(10, 4, device='cpu')\n"
            "c.encode_parity(torch.zeros((10, 16), dtype=torch.uint8))\n"
            "d = sys.argv[1]\n"
            "bases = [os.path.join(d, v) for v in ('1', '2')]\n"
            "for b, n in zip(bases, (30_000, 5_000)):\n"
            "    open(b + '.dat', 'wb').write(os.urandom(n))\n"
            "fleet_convert.convert_volumes(bases, large_block=1000, "
            "small_block=100, device='cpu')\n"
            "open(bases[0] + '.ecx', 'wb').close()\n"
            "ev = ec_volume.EcVolume(bases[0], 1000, 100, device='cpu')\n"
            "scrub.DEFAULT_WINDOW = 512\n"
            "assert scrub.syndrome_scan(ev) == []\n"
            "ev.close()\n"
            "b = bases[0]\n"
            "want = open(b + '.ec03', 'rb').read()\n"
            "os.remove(b + '.ec03')\n"
            "held = {s: np.fromfile(b + '.ec%02d' % s, np.uint8) "
            "for s in (10, 11, 12, 13)}\n"
            "for s in held:\n"
            "    os.remove(b + '.ec%02d' % s)\n"
            "def fetch(group, sids, coeff, off, n):\n"
            "    rows = np.stack([held[s][off:off + n] for s in sids])\n"
            "    return dispatch.apply_matrix(c, coeff, rows).tobytes()\n"
            "r = ec_files.rebuild_ec_reduced(b, [3], [{'node': 'h', "
            "'shards': sorted(held), 'locality': 1}], fetch, device='cpu')\n"
            "assert r['rebuilt'] == [3] and r['helper_bytes'] == {'h': 3000}\n"
            "assert open(b + '.ec03', 'rb').read() == want\n"
            "m = codecs.make_codec('msr_9_16', device='cpu')\n"
            "full = m.encode(torch.from_numpy(np.frombuffer(os.urandom(9 * 64),"
            " np.uint8).reshape(9, 64).copy())).numpy()\n"
            "mb = os.path.join(d, '9')\n"
            "for s in range(1, 6):\n"
            "    open(mb + '.ec%02d' % s, 'wb').write(full[s].tobytes())\n"
            "ec_files.write_vif(mb, 9 * 64, codec='msr_9_16')\n"
            "def sub_fetch(group, vids, coeff, off, n):\n"
            "    rows = np.stack([full[v // 8][off * 8:(off + n) * 8]"
            ".reshape(n, 8)[:, v % 8] for v in vids])\n"
            "    return dispatch.apply_matrix(m, coeff, rows).tobytes()\n"
            "r = ec_files.rebuild_ec_reduced(mb, [0], [{'node': 'h', "
            "'shards': list(range(6, 18)), 'locality': 1}], sub_fetch, "
            "device='cpu')\n"
            "assert r['helper_bytes'] == {'h': 11 * 8}, r\n"
            "assert open(mb + '.ec00', 'rb').read() == full[0].tobytes()\n"
            "os.environ['WEEDTPU_EC_CODEC'] = 'native'\n"
            "nb = os.path.join(d, '8')\n"
            "open(nb + '.dat', 'wb').write(os.urandom(25_000))\n"
            "st = {}\n"
            "ec_files.write_ec_files(nb, large_block=1000, small_block=100, "
            "stats=st)\n"
            "assert st['mode'] == 'pipelined'\n"
            "want = open(nb + '.ec12', 'rb').read()\n"
            "os.remove(nb + '.ec12')\n"
            "st = {}\n"
            "ec_files.rebuild_ec_files(nb, stats=st)\n"
            "assert st['mode'] == 'host-serial'\n"
            "assert open(nb + '.ec12', 'rb').read() == want\n"
            "os.environ.pop('WEEDTPU_EC_CODEC')\n"
            "from seaweedfs_tpu_torch.storage import needle, store\n"
            "sd = os.path.join(d, 'node')\n"
            "s = store.Store([sd], device='cpu')\n"
            "s.allocate_volume(5)\n"
            "for nid in range(1, 41):\n"
            "    s.write_needle(5, needle.Needle(id=nid, cookie=nid, "
            "data=os.urandom(3000)))\n"
            "for nid in range(2, 41, 3):\n"
            "    s.delete_needle(5, nid)\n"
            "s.get_volume(5).compact()\n"
            "s.close()\n"
            "vb = os.path.join(sd, '5')\n"
            "ec_files.write_ec_files(vb, large_block=1000, small_block=100, "
            "device='cpu')\n"
            "ec_files.write_sorted_ecx(vb + '.idx')\n"
            "want = open(vb + '.dat', 'rb').read()\n"
            "for p in (vb + '.dat', vb + '.idx', vb + '.ec01', vb + '.ec07'):\n"
            "    os.remove(p)\n"
            "s = store.Store([sd], device='cpu')\n"
            "assert s.get_ec_volume(5) is not None\n"
            "s.close()\n"
            "ec_files.rebuild_ec_files(vb, device='cpu')\n"
            "ec_files.write_dat_file(vb, ec_files.find_dat_file_size(vb), "
            "1000, 100)\n"
            "ec_files.write_idx_from_ecx(vb + '.ecx')\n"
            "assert open(vb + '.dat', 'rb').read() == want\n"
            "v = s.allocate_volume(6)\n"
            "v.append_needle(needle.Needle(id=1, data=b'cold'))\n"
            "v.tier_move('local', {'directory': os.path.join(d, 'cold')})\n"
            "assert v.read_needle(1).data == b'cold'\n"
            "v.close()\n"
            "import shutil, threading, time\n"
            "from http.server import BaseHTTPRequestHandler, "
            "ThreadingHTTPServer\n"
            "from seaweedfs_tpu_torch.stats import metrics\n"
            "from seaweedfs_tpu_torch.utils import http\n"
            "peer = ec_volume.EcVolume(vb, 1000, 100, device='cpu')\n"
            "delay = [0.0]\n"
            "class Peer(BaseHTTPRequestHandler):\n"
            "    protocol_version = 'HTTP/1.1'\n"
            "    disable_nagle_algorithm = True\n"
            "    def do_GET(self):\n"
            "        q = dict(p.split('=') for p in "
            "self.path.split('?')[1].split('&'))\n"
            "        time.sleep(delay[0])\n"
            "        b = peer._read_local(int(q['shard']), int(q['offset']), "
            "int(q['size']))\n"
            "        self.send_response(200)\n"
            "        self.send_header('Content-Length', str(len(b)))\n"
            "        self.end_headers()\n"
            "        self.wfile.write(b)\n"
            "    def log_message(self, *a):\n"
            "        pass\n"
            "srv = ThreadingHTTPServer(('127.0.0.1', 0), Peer)\n"
            "threading.Thread(target=srv.serve_forever, daemon=True).start()\n"
            "pool = http.PooledHTTP(timeout=5.0)\n"
            "url = ('http://127.0.0.1:%d/admin/ec/shard_read?volume=5&'\n"
            "       'shard=%d&offset=%d&size=%d')\n"
            "def reader(sid, off, size):\n"
            "    st, _, b = pool.request(url % (srv.server_address[1], sid, "
            "off, size))\n"
            "    return b if st == 200 else None\n"
            "rd = os.path.join(d, 'reader')\n"
            "os.makedirs(rd)\n"
            "for ext in ['.ecx', '.vif'] + ['.ec%02d' % i for i in "
            "range(2, 14)]:\n"
            "    shutil.copy(vb + ext, os.path.join(rd, '5' + ext))\n"
            "ev = ec_volume.EcVolume(os.path.join(rd, '5'), 1000, 100, "
            "device='cpu')\n"
            "nid = int(ev.ids[0])\n"
            "want = peer.read_needle(nid).data\n"
            "os.environ['WEEDTPU_HEDGE_PCT'] = '0'\n"
            "assert ev.read_needle(nid, reader).data == want\n"
            "assert ev.read_stats['remote_shard_reads'] > 0\n"
            "assert ev.read_stats['reconstruct_batches'] == 0\n"
            "os.environ['WEEDTPU_HEDGE_PCT'] = '99'\n"
            "os.environ['WEEDTPU_HEDGE_MAX_MS'] = '50'\n"
            "delay[0] = 0.2\n"
            "assert ev.read_needle(nid, reader).data == want\n"
            "assert metrics.HEDGE_TOTAL.labels('hedge_won').value == 1\n"
            "assert ev.read_stats['reconstruct_batches'] == 1\n"
            "time.sleep(0.3)\n"
            "srv.shutdown()\n"
            "pool.close()\n"
            "from seaweedfs_tpu_torch.parallel import dryrun\n"
            "dryrun.dryrun_multichip(8, devices=['cpu'] * 8)\n"
            "cpu4 = ['cpu'] * 4\n"
            "mb = os.path.join(d, '12')\n"
            "open(mb + '.dat', 'wb').write(os.urandom(20_000))\n"
            "os.environ['WEEDTPU_EC_CODEC'] = 'mesh'\n"
            "ec_files.write_ec_files(mb, large_block=1000, small_block=100, "
            "device=cpu4)\n"
            "want = open(mb + '.ec11', 'rb').read()\n"
            "os.remove(mb + '.ec11')\n"
            "ec_files.rebuild_ec_files(mb, device=cpu4)\n"
            "assert open(mb + '.ec11', 'rb').read() == want\n"
            "os.environ.pop('WEEDTPU_EC_CODEC')\n"
            "fleet_convert.convert_volumes([mb], large_block=1000, "
            "small_block=100, codec=fleet_convert.fleet_codec('mesh', "
            "device=cpu4))\n"
            "assert open(mb + '.ec11', 'rb').read() == want\n"
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "or m.startswith('seaweedfs_tpu.') for m in sys.modules), "
            "sorted(m for m in sys.modules if 'jax' in m)\n")
    subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                   check=True, timeout=120)


# ---- entry points need the card -----------------------------------------

@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_get_codec_without_card_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gf_cuda.get_codec(10, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codecs.make_codec("rs_10_4")
    assert gf_cuda.get_codec(10, 4, device="cpu").device.type == "cpu"


def test_rebuild_ec_reduced_without_card_raises(tmp_path, no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ec_files.rebuild_ec_reduced(str(tmp_path / "1"), [0], [],
                                    lambda *a: b"")


def test_non_rs_family_is_not_ported():
    """The LRC and MSR families are ported now: make_codec builds both on
    the CPU, with the reference's geometry (the name is kept from when it
    refused them)."""
    from seaweedfs_tpu_torch.ops import msr
    lc = codecs.make_codec("lrc_10_2_2", device="cpu")
    assert (lc.k, lc.m, lc.n) == (10, 4, 14) and lc.device.type == "cpu"
    mc = codecs.make_codec("msr_9_16", device="cpu")
    assert isinstance(mc, msr.MSRFileCodec)
    assert (mc.k, mc.m, mc.n, mc.alpha) == (9, 9, 18, 8)
    assert mc.inner.code.parity_matrix.shape == (72, 72)


def test_kernel_wrapper_refuses_cpu_tensors():
    coef = torch.zeros((4, 10), dtype=torch.uint8)
    with pytest.raises(ValueError, match="on one card"):
        gf_cuda.gf_apply_cuda(coef, torch.zeros((1, 10, 32),
                                                dtype=torch.uint8))
    # any [m, k] a GF(2^8) code can give is taken (fault 3.3); past
    # k + m = 256 no code exists, and the matrix is refused
    assert gf_cuda.CudaGFMatrix(np.ones((17, 10), np.uint8)).m == 17
    with pytest.raises(ValueError, match="k \\+ m <= 256"):
        gf_cuda.CudaGFMatrix(np.ones((17, 240), np.uint8))


# ---- tables and matrices -------------------------------------------------

def test_gf_tables_equal_reference():
    assert np.array_equal(gf.GF_EXP, ref_gf.GF_EXP)
    assert np.array_equal(gf.GF_LOG, ref_gf.GF_LOG)
    assert np.array_equal(gf.GF_MUL_TABLE, ref_gf.GF_MUL_TABLE)
    C = np.random.default_rng(7).integers(0, 256, (4, 10), dtype=np.uint8)
    assert np.array_equal(gf.gf_matrix_to_bitmatrix(C),
                          ref_gf.gf_matrix_to_bitmatrix(C))
    assert np.array_equal(gf.gf_mat_inv(rs.vandermonde(10, 10)),
                          ref_gf.gf_mat_inv(ref_rs.vandermonde(10, 10)))


KM = [(6, 3), (10, 4), (12, 4), (16, 4)]


@pytest.mark.parametrize("k,m", KM)
def test_rs_matrix_equals_reference(k, m):
    mine, ref = rs.get_code(k, m), ref_rs.get_code(k, m)
    assert np.array_equal(mine.matrix, ref.matrix)
    assert np.array_equal(rs.from_reference(ref.matrix, k, m).matrix,
                          ref.matrix)


@pytest.mark.parametrize("k,m", KM)
def test_decode_matrices_equal_reference(k, m):
    """15 random survivor/wanted patterns per code (60 in all)."""
    mine, ref = rs.get_code(k, m), ref_rs.get_code(k, m)
    g = np.random.default_rng(k * 100 + m)
    for _ in range(15):
        lost = sorted(g.choice(k + m, size=int(g.integers(1, m + 1)),
                               replace=False).tolist())
        avail = [i for i in range(k + m) if i not in lost]
        wanted = lost if g.random() < 0.7 else \
            sorted(g.choice(k + m, size=2, replace=False).tolist())
        assert np.array_equal(mine.decode_matrix(avail, wanted),
                              ref.decode_matrix(avail, wanted))


def test_from_reference_rejects_non_systematic():
    with pytest.raises(ValueError, match="systematic"):
        rs.from_reference(np.ones((14, 10), np.uint8), 10, 4)


# ---- the plain version against the JAX kernels ---------------------------

def _matrix(kind: str) -> np.ndarray:
    code = ref_rs.get_code(10, 4)
    if kind == "parity":
        return code.parity_matrix
    if kind == "decode":
        return code.decode_matrix([1, 2, 4, 5, 6, 7, 8, 9, 11, 13],
                                  [0, 3, 10, 12])
    return np.random.default_rng(11).integers(0, 256, (4, 10),
                                              dtype=np.uint8)


@pytest.mark.parametrize("kind", ["random", "parity", "decode"])
@pytest.mark.parametrize("n", [1, 255, 4097, 5000])
def test_plain_equals_pallas_jax_and_numpy(kind, n):
    C = _matrix(kind)
    x = np.random.default_rng(n).integers(0, 256, (10, n), dtype=np.uint8)
    got = gf_cuda.CudaGFMatrix(C)(torch.from_numpy(x)).numpy()
    pallas = np.asarray(pallas_gf.PallasGFMatrix(C, tile=256,
                                                 interpret=True)(x))
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, np.asarray(gfmat_jax.JaxGFMatrix(C)(x)))
    assert np.array_equal(got, ref_gf.gf_matmul(C, x))


def test_plain_on_strided_rows():
    """The pipeline hands the codec [:, :step] views of a wider buffer."""
    C = _matrix("parity")
    buf = np.random.default_rng(3).integers(0, 256, (10, 4096),
                                            dtype=np.uint8)
    got = gf_cuda.CudaGFMatrix(C)(torch.from_numpy(buf)[:, :1000]).numpy()
    assert np.array_equal(got, ref_gf.gf_matmul(C, buf[:, :1000]))


def test_apply_batch_equals_jax_batch():
    C = _matrix("random")
    x = np.random.default_rng(5).integers(0, 256, (3, 10, 4097),
                                          dtype=np.uint8)
    mat = gf_cuda.CudaGFMatrix(C)
    got = mat.apply_batch(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 4, 4097)
    assert np.array_equal(got, np.asarray(pallas_gf.PallasGFMatrix(
        C, tile=256, interpret=True).apply_batch(x)))
    assert np.array_equal(got, np.asarray(
        gfmat_jax.JaxGFMatrix(C).apply_batch(x)))


# ---- codec shell ------------------------------------------------------------

def test_codec_round_trip_equals_pallas_codec():
    ref_code = ref_rs.get_code(10, 4)
    mine = gf_cuda.CudaRSCodec(rs.from_reference(ref_code.matrix, 10, 4),
                               device="cpu")
    ref = pallas_gf.PallasRSCodec(ref_code, tile=256, interpret=True)
    data = np.random.default_rng(9).integers(0, 256, (10, 700),
                                             dtype=np.uint8)
    shards = mine.encode(torch.from_numpy(data)).numpy()
    assert np.array_equal(shards, np.asarray(ref.encode(data)))
    patterns = list(itertools.combinations(range(14), 4))
    g = np.random.default_rng(2)
    for idx in g.choice(len(patterns), size=6, replace=False):
        lost = list(patterns[idx])
        present = {i: torch.from_numpy(shards[i])
                   for i in range(14) if i not in lost}
        out = mine.reconstruct(present)
        ref_out = ref.reconstruct({i: shards[i] for i in present})
        for i in lost:
            assert np.array_equal(out[i].numpy(), shards[i]), (lost, i)
            assert np.array_equal(out[i].numpy(), np.asarray(ref_out[i]))


def test_codec_stacks_rows_16_bytes_apart():
    """encode and reconstruct hand the apply rows 16 bytes apart whatever
    n is, so on the card the kernel reads their stack in place (a
    contiguous [10, 700] used to be refused there)."""
    strides = []

    class Spy(gf_cuda.CudaGFMatrix):
        def _apply(self, x, name):
            strides.append(x.stride(-2))
            return super()._apply(x, name)

    code = rs.get_code(10, 4)
    codec = codec_base.RSCodecBase(code, Spy)
    data = np.random.default_rng(12).integers(0, 256, (10, 700),
                                              dtype=np.uint8)
    shards = codec.encode(torch.from_numpy(data))
    want = np.concatenate([data, ref_gf.gf_matmul(code.parity_matrix, data)])
    assert np.array_equal(shards.numpy(), want)
    lost = (0, 3, 10, 12)
    out = codec.reconstruct({i: torch.from_numpy(want[i])
                             for i in range(14) if i not in lost})
    for i in lost:
        assert np.array_equal(out[i].numpy(), want[i])
    assert len(strides) == 2
    assert all(s % gf_cuda.ALIGN == 0 for s in strides), strides


def test_decode_cache_is_lru_bounded(monkeypatch):
    monkeypatch.setenv("WEEDTPU_CODEC_DECODE_CACHE", "2")
    codec = gf_cuda.CudaRSCodec(rs.get_code(6, 3), device="cpu")
    shards = codec.encode(torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (6, 64), dtype=np.uint8)))
    for lost in ([0], [1], [2], [0, 4]):
        got = codec.reconstruct({i: shards[i] for i in range(9)
                                 if i not in lost})
        for i in lost:
            assert torch.equal(got[i], shards[i])
    assert len(codec._decode_cache) == 2


def test_dispatch_seam_on_cpu():
    codec = gf_cuda.get_codec(10, 4, device="cpu")
    data = np.random.default_rng(6).integers(0, 256, (10, 333),
                                             dtype=np.uint8)
    parity = dispatch.materialize(dispatch.dispatch_parity(codec, data))
    assert np.array_equal(parity,
                          ref_gf.gf_matmul(ref_rs.get_code().parity_matrix,
                                           data))
    mism = dispatch.parity_mismatch(codec, data, {0: parity[0].tobytes(),
                                                  1: parity[1] ^ 1})
    assert not mism[0].any() and mism[1].all()
    shards = {i: data[i] for i in range(10) if i not in (2, 7)}
    shards.update({10: parity[0], 11: parity[1]})
    out = dispatch.reconstruct_batch(codec, shards, [2, 7])
    assert np.array_equal(out[2], data[2]) and np.array_equal(out[7], data[7])


def test_launch_counts_only_where_the_kernel_launches():
    """CPU tensors, empty ones included, go to the plain version and count
    nothing; the kernel wrapper refuses a CPU tensor before it counts."""
    mat = gf_cuda.CudaGFMatrix(_matrix("parity"))
    before = dict(gf_cuda.LAUNCHES)
    staged = dict(gf_cuda.STAGED)
    for shape in ((10, 0), (10, 33)):
        assert mat(torch.zeros(shape, dtype=torch.uint8)).shape == \
            (4, shape[1])
    assert mat.apply_batch(torch.zeros((0, 10, 16), dtype=torch.uint8)
                           ).shape == (0, 4, 16)
    with pytest.raises(ValueError):
        gf_cuda.gf_apply_cuda(torch.zeros((4, 10), dtype=torch.uint8),
                              torch.zeros((1, 10, 16), dtype=torch.uint8))
    assert gf_cuda.LAUNCHES == before
    assert gf_cuda.STAGED == staged


def test_padded_staging_keeps_rows_aligned():
    """The dispatch seam lands every batch with rows 16 bytes apart, the
    layout the kernel reads in place."""
    for n in (1, 16, 255, 4097):
        x = dispatch.device_empty((10, n), torch.device("cpu"))
        assert x.shape == (10, n) and x.stride() == (
            gf_cuda.padded_width(n), 1)
        assert gf_cuda.padded_width(n) % gf_cuda.ALIGN == 0


@pytest.mark.parametrize("view, in_place", [
    ("padded", True), ("padded_units", True), ("one_row", True),
    ("contiguous_700", False), ("offset", False), ("transposed", False)])
def test_kernel_reads_in_place_only_aligned_rows(view, in_place):
    """Which [U, k, n] views the wrapper hands the kernel as they lie and
    which it stages a padded copy of first: rows 16 bytes apart on a
    16-byte base are read in place, and nothing else."""
    wide = dispatch.device_empty((3, 10, 4097), torch.device("cpu"))
    x = {"padded": wide[:1],
         "padded_units": wide,
         "one_row": torch.zeros((1, 1, 700), dtype=torch.uint8),
         "contiguous_700": torch.zeros((1, 10, 700), dtype=torch.uint8),
         "offset": wide[:1, :, 1:],
         "transposed": torch.zeros((1, 64, 10),
                                   dtype=torch.uint8).transpose(1, 2),
         }[view]
    assert gf_cuda._in_place(x) is in_place
