"""The port shell's `mq.*` commands and the port CLI's `mq.broker` and
`server -mq`, on port clusters (the port's master and a port volume
server with `device="cpu"`, in process on one loop thread, with port
brokers).

- The twin of tests/test_shell_commands.py's
  `TestBreadthCommands::test_mq_commands`, keeping its name and checks.
- Both shells over one cluster print the same for the four `mq.*`
  commands, and fail alike where there is no broker or no topic.
- The CLI's `mq.broker` and `server -mq`, each in a child that loads
  neither jax nor the reference package (nor torch, for `mq.broker`):
  the reference's `MQClient` configures, publishes and fetches through
  it, byte for byte.
"""

import asyncio
import io
import json
import threading
import urllib.request

import pytest

from seaweedfs_tpu.mq.client import MQClient as RefMQClient
from seaweedfs_tpu.shell import commands as ref_commands
from seaweedfs_tpu_torch.mq.client import MQClient
from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command
from tests.test_torch_master_cluster import start_cli
from tests.test_torch_mq import Brokers, settled, until


@pytest.fixture(autouse=True)
def _quiet_cluster(monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB_MBPS", "0")
    monkeypatch.setenv("WEEDTPU_REPAIR_INTERVAL", "0")
    monkeypatch.setenv("WEEDTPU_AGG_INTERVAL", "0")


def shell(env, line) -> str:
    buf = io.StringIO()
    run_command(env, line, buf)
    return buf.getvalue()


def ref_shell(env, line) -> str:
    buf = io.StringIO()
    ref_commands.run_command(env, line, buf)
    return buf.getvalue()


def _brokers_listed(env, n) -> bool:
    return len(env.master_get("/cluster/status").get("Members", {})
               .get("broker", [])) == n


# ---- twin of tests/test_shell_commands.py -----------------------------------

def test_mq_commands(tmp_path):
    s = Brokers(tmp_path)
    try:
        s.start()
        env = CommandEnv(s.c.master.url)
        until(lambda: _brokers_listed(env, 1), "the broker registered")
        out = shell(env, "mq.topic.configure -topic shell.t "
                         "-partitionCount 2")
        assert "partitions=2" in out
        out = shell(env, "mq.topic.list")
        assert "shell.t" in out
        out = shell(env, "mq.topic.desc -topic shell.t")
        assert "partition 0" in out and "partition 1" in out
        out = shell(env, "mq.balance")
        assert "broker ring" in out and "shell.t" in out and "p1:" in out
    finally:
        s.close()


# ---- both shells on one cluster ---------------------------------------------

def test_both_shells_print_alike_for_the_mq_commands(tmp_path):
    s = Brokers(tmp_path)
    try:
        env = CommandEnv(s.c.master.url)
        renv = ref_commands.CommandEnv(s.c.master.url)
        # no broker registered yet
        assert shell(env, "mq.balance") == ref_shell(renv, "mq.balance") \
            == "no brokers registered\n"
        for e, run in ((env, shell), (renv, ref_shell)):
            with pytest.raises(RuntimeError, match="no mq broker "
                               "registered with the master"):
                run(e, "mq.topic.list")
        brokers = [s.start(peer_refresh=0.3) for _ in range(2)]
        until(lambda: settled(brokers) and _brokers_listed(env, 2),
              "two brokers in one ring, both registered")
        assert shell(env, "mq.topic.list") == \
            ref_shell(renv, "mq.topic.list") == "(no topics)\n"
        for name, n in (("sh.a", 3), ("sh.b", 1)):
            line = f"mq.topic.configure -topic {name} -partitionCount {n}"
            out = shell(env, line)
            assert out == ref_shell(renv, line) == \
                f"topic {name} partitions={n}\n"
        client = MQClient([b.url for b in brokers])
        for i in range(12):
            client.publish("sh.a", b"m%d" % i, key=b"%d" % i)
        client.publish("sh.b", b"one")
        for line in ("mq.topic.list", "mq.topic.desc -topic sh.a",
                     "mq.topic.desc -topic sh.b", "mq.balance"):
            out = shell(env, line)
            assert out == ref_shell(renv, line), line
            assert out
        assert "next_offsets=[" in shell(env, "mq.topic.list")
        for e, run in ((env, shell), (renv, ref_shell)):
            with pytest.raises(RuntimeError, match="topic 'sh.none' not "
                               "found"):
                run(e, "mq.topic.desc -topic sh.none")
    finally:
        s.close()


# ---- the CLI ------------------------------------------------------------------

# a CLI child that also says whether torch was loaded
MQ_CHILD = r"""
import json, os, sys, threading, traceback
from seaweedfs_tpu_torch.__main__ import main
def serve():
    try:
        main(sys.argv[1:])
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(3)
threading.Thread(target=serve, daemon=True).start()
sys.stdin.readline()
print(json.dumps({"jax": "jax" in sys.modules,
                  "torch": "torch" in sys.modules,
                  "reference": sorted(m for m in sys.modules
                                      if m.split(".")[0] ==
                                      "seaweedfs_tpu")}), flush=True)
os._exit(0)
"""


def _get(url):
    with urllib.request.urlopen(url, timeout=2) as r:
        return json.loads(r.read())


class PortMaster:
    def __init__(self):
        from seaweedfs_tpu_torch.server.master import MasterServer
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        from tests.test_torch_master_cluster import free_port
        self.master = MasterServer("127.0.0.1", free_port())
        self.run(self.master.start())
        self.url = self.master.url

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def stop(self):
        try:
            self.run(self.master.stop())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(10)


@pytest.mark.parametrize("mode", ["mq.broker", "server -mq"])
def test_cli_broker_serves_the_reference_client(tmp_path, mode):
    """`python -m seaweedfs_tpu_torch mq.broker -master ...` beside a port
    master, or one `server -device cpu -mq`: the broker registers with
    the master, the reference's `MQClient` configures a topic, publishes
    and fetches every byte back through it, and the child imported
    neither jax nor the reference package (nor torch, as `mq.broker`)."""
    pm = PortMaster() if mode == "mq.broker" else None
    (tmp_path / "d").mkdir()

    def argvs(ports):
        if pm is not None:
            return [["mq.broker", "-master", pm.url, "-port",
                     str(ports[0])]]
        return [["server", "-dir", str(tmp_path / "d"), "-port",
                 str(ports[1]), "-volumePort", str(ports[2]), "-device",
                 "cpu", "-mdir", str(tmp_path / "m"), "-mq", "-mqPort",
                 str(ports[0])]]

    def master_of(ports):
        return pm.url if pm is not None else f"127.0.0.1:{ports[1]}"

    def registered(ports):
        broker = f"127.0.0.1:{ports[0]}"
        listed = _get(f"http://{master_of(ports)}/cluster/status") \
            .get("Members", {}).get("broker", [])
        return listed == [broker] and \
            _get(f"http://{broker}/status")["brokers"] == [broker]
    procs = []
    try:
        procs, ports, _ = start_cli(tmp_path, argvs, 3, registered,
                                    child=MQ_CHILD)
        client = RefMQClient([f"127.0.0.1:{ports[0]}"])
        client.configure("cli.mq", partition_count=2)
        sent = {}
        for i in range(16):
            value = bytes(range(32, 127))[:i * 5] + b"%d" % i
            sent[client.publish("cli.mq", value, key=b"k%d" % i)] = value
        got = {}
        for pi in range(2):
            msgs, nxt = client.fetch("cli.mq", pi, 0)
            got.update({(pi, m["offset"]): m["value"].encode()
                        for m in msgs})
        assert got == sent
        for p in procs:
            out, _ = p.communicate(b"report\n", timeout=60)
            report = json.loads(out.decode().strip().splitlines()[-1])
            assert report["jax"] is False and report["reference"] == []
            if pm is not None:
                assert report["torch"] is False
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        if pm is not None:
            pm.stop()
