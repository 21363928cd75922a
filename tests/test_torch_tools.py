"""The GPU-instance group tool, ``ewdml_tpu_torch/tools/gpu_pod.py``: the
port's counterpart of ``tests/test_tools.py``, case for case.

Oracles (exact): each verb's argv in dry-run form; the parsed hosts and
the ``hosts``/``hosts_alias`` files, the files byte-equal to the JAX
tool's for the same hosts; the verb map run for real against a ``gcloud``
stand-in on ``PATH`` (no ``gcloud`` runs); the dataset tool's failure
paths against loopback origins only.
"""

import json
import os
import socket
import stat
import subprocess
import sys

import pytest

from ewdml_tpu.tools import tpu_pod
from ewdml_tpu_torch.data import prepare
from ewdml_tpu_torch.tools import gpu_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIST = json.dumps([
    {"name": "pod0-1", "networkInterfaces": [
        {"networkIP": "10.0.0.3", "accessConfigs": [{}]}]},
    {"name": "pod0-0", "networkInterfaces": [
        {"networkIP": "10.0.0.2",
         "accessConfigs": [{"natIP": "34.1.2.3"}]}]},
])


def _cfg(**kw):
    return gpu_pod.PodConfig(name="pod0", zone="us-z", **kw)


def _shim(tmp_path, monkeypatch, body: str):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    script = bindir / "gcloud"
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")


class TestCommands:
    def test_launch(self):
        cmd = gpu_pod.launch_cmd(_cfg(spot=True, count=3))
        assert cmd[:4] == ["gcloud", "compute", "instances", "create"]
        assert cmd[4:7] == ["pod0-0", "pod0-1", "pod0-2"]
        assert cmd[cmd.index("--machine-type") + 1] == "a3-highgpu-1g"
        assert cmd[-2:] == ["--provisioning-model", "SPOT"]
        assert "--provisioning-model" not in gpu_pod.launch_cmd(_cfg())

    def test_terminate_and_describe(self):
        t = gpu_pod.terminate_cmd(_cfg())
        assert t[2:7] == ["instances", "delete", "pod0-0", "pod0-1",
                          "--quiet"]
        d = gpu_pod.describe_cmd(_cfg(project="proj"))
        assert d[2:4] == ["instances", "list"]
        assert d[d.index("--filter") + 1] == "name ~ ^pod0-[0-9]+$"
        assert d[d.index("--project") + 1] == "proj"
        assert d[d.index("--format") + 1] == "json"

    def test_run_fans_out_to_every_host(self):
        cmds = gpu_pod.run_cmds(_cfg(count=3), "hostname")
        assert [c[3] for c in cmds] == ["pod0-0", "pod0-1", "pod0-2"]
        for c in cmds:
            assert c[:3] == ["gcloud", "compute", "ssh"]
            assert c[-2:] == ["--command", "hostname"]
            assert c[c.index("--zone") + 1] == "us-z"

    def test_kill_python_is_a_run(self):
        cmds = gpu_pod.kill_python_cmds(_cfg())
        assert len(cmds) == 2
        assert all(c[-1] == "pkill -f python || true" for c in cmds)

    def test_copy_code(self):
        cmds = gpu_pod.copy_code_cmds(_cfg(), src="/src")
        assert [c[3:6] for c in cmds] == [
            ["--recurse", "/src", "pod0-0:~/ewdml_tpu"],
            ["--recurse", "/src", "pod0-1:~/ewdml_tpu"]]
        assert all(c[2] == "scp" for c in cmds)

    def test_execute_dry_run_returns_string(self):
        assert gpu_pod.execute(["gcloud", "x"], dry_run=True) == "gcloud x"
        assert gpu_pod.execute_all([["gcloud", "x"], ["gcloud", "y z"]],
                                   dry_run=True) == "gcloud x\ngcloud 'y z'"

    def test_cli_dry_run(self, capsys):
        rc = gpu_pod.main(["launch", "--name", "p", "--zone", "z",
                           "--count", "1", "--dry-run"])
        assert rc == 0
        assert "compute instances create p-0 --zone z" in \
            capsys.readouterr().out

    def test_module_run_prints_the_fan_out(self):
        out = subprocess.run(
            [sys.executable, "-m", "ewdml_tpu_torch.tools.gpu_pod", "run",
             "--dry-run", "--command", "hostname"], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        assert out.stdout.splitlines() == [
            f"gcloud compute ssh ewdml-pod-{i} --zone us-central1-a "
            "--command hostname" for i in range(2)]


class TestHosts:
    def test_parse_hosts(self):
        hosts = gpu_pod.parse_hosts(LIST)
        assert [h["name"] for h in hosts] == ["pod0-0", "pod0-1"]
        assert hosts[0]["internal_ip"] == "10.0.0.2"
        assert hosts[0]["external_ip"] == "34.1.2.3"
        assert hosts[1]["external_ip"] == ""

    def test_write_hosts_files(self, tmp_path):
        hosts = gpu_pod.parse_hosts(LIST)
        prefix = str(tmp_path / "port") + os.sep
        os.makedirs(prefix)
        gpu_pod.write_hosts_files(hosts, prefix)
        lines = (tmp_path / "port" / "hosts").read_text().splitlines()
        assert lines == ["10.0.0.2 worker0", "10.0.0.3 worker1"]
        alias = (tmp_path / "port" / "hosts_alias").read_text().splitlines()
        assert alias == ["10.0.0.2", "10.0.0.3"]
        # The JAX tool writes the same files for the same hosts.
        jprefix = str(tmp_path / "jax") + os.sep
        os.makedirs(jprefix)
        tpu_pod.write_hosts_files(hosts, jprefix)
        for name in ("hosts", "hosts_alias"):
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes()


class TestDataPrepare:
    def test_offline_is_graceful(self, tmp_path):
        # A loopback port with nothing listening stands for no egress: the
        # download fails softly, and the dataset is not ready.
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ok = prepare.prepare("mnist", str(tmp_path),
                             mirror=f"http://127.0.0.1:{port}/")
        assert ok is False

    def test_unknown_dataset_raises(self, tmp_path):
        with pytest.raises(ValueError):
            prepare.prepare("imagenet", str(tmp_path))


class TestFakeGcloudIntegration:
    """The verb map run for real against a ``gcloud`` stand-in: the
    subprocess calls, the fan-out, the list parsing and the host files."""

    @pytest.fixture
    def fake_gcloud(self, tmp_path, monkeypatch):
        log = tmp_path / "gcloud.log"
        _shim(tmp_path, monkeypatch,
              f'echo "$@" >> "{log}"\n'
              'case "$*" in\n'
              f"  *instances\\ list*) cat <<'JSON'\n{LIST}\nJSON\n;;\n"
              '  *) echo "done: $2 $3" ;;\n'
              "esac\n")
        return log

    def test_verb_map_executes(self, fake_gcloud):
        cfg = gpu_pod.PodConfig(name="pod0", zone="z", spot=True)
        out = gpu_pod.execute(gpu_pod.launch_cmd(cfg))
        assert "done: instances create" in out
        out = gpu_pod.execute_all(gpu_pod.run_cmds(cfg, "hostname"))
        assert out == "done: ssh pod0-0\ndone: ssh pod0-1\n"
        gpu_pod.execute_all(gpu_pod.kill_python_cmds(cfg))
        gpu_pod.execute(gpu_pod.terminate_cmd(cfg))
        lines = fake_gcloud.read_text().strip().splitlines()
        verbs = [" ".join(ln.split()[1:3]) for ln in lines]
        assert verbs[0] == "instances create" and verbs[-1] == \
            "instances delete"
        assert sorted(verbs[1:5]) == ["ssh pod0-0", "ssh pod0-0",
                                      "ssh pod0-1", "ssh pod0-1"]
        assert "--provisioning-model SPOT" in lines[0]
        assert sum("--command pkill -f python || true" in ln
                   for ln in lines) == 2

    def test_get_hosts_parses_and_writes_hostfiles(self, fake_gcloud,
                                                   tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        rc = gpu_pod.main(["get_hosts", "--name", "pod0", "--zone", "z"])
        assert rc == 0
        hosts = (tmp_path / "hosts").read_text().splitlines()
        assert hosts == ["10.0.0.2 worker0", "10.0.0.3 worker1"]
        alias = (tmp_path / "hosts_alias").read_text().splitlines()
        assert alias == ["10.0.0.2", "10.0.0.3"]
        assert "instances list" in fake_gcloud.read_text()

    def test_execute_raises_on_failure(self, tmp_path, monkeypatch):
        _shim(tmp_path, monkeypatch, "echo boom >&2\nexit 1\n")
        cfg = gpu_pod.PodConfig(name="pod0")
        with pytest.raises(RuntimeError, match="boom"):
            gpu_pod.execute(gpu_pod.describe_cmd(cfg))
        with pytest.raises(RuntimeError, match="2 of 2 hosts: .*boom"):
            gpu_pod.execute_all(gpu_pod.run_cmds(cfg, "hostname"))
