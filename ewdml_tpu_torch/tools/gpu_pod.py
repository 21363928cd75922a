"""A group of GPU instances: the reference's EC2 provisioner, retargeted.

The counterpart of ``ewdml_tpu/tools/tpu_pod.py``, which retargets the
reference's ``tools/pytorch_ec2.py`` (``launch_instances:176``,
``get_hosts:656``, ``kill_all_python:841``, ``run_command:854``, the
command map ``:938-951``) and its SSH shell glue to a Cloud TPU pod. A TPU
pod is one resource whose ``--worker=all`` fans a command out; a group of
GPU instances is N resources, ``<name>-0`` ... ``<name>-<N-1>``, one card
each by default (``a3-highgpu-1g``: one H100 80GB), so here each verb is a
``gcloud compute instances`` argv over the group, or one ``gcloud compute
ssh|scp`` argv a host, which :func:`execute_all` runs at once. What each
replaces in ``tpu_pod.py``: :class:`PodConfig` ``:40``, :func:`launch_cmd`
``:65``, :func:`terminate_cmd` ``:76``, :func:`describe_cmd` ``:81``,
:func:`run_cmds` ``:86`` (``run_cmd``), :func:`kill_python_cmds` ``:93``,
:func:`copy_code_cmds` ``:98``, :func:`parse_hosts` ``:104``,
:func:`write_hosts_files` ``:118``, :func:`execute` ``:131``,
:data:`VERBS` ``:142``, :func:`main` ``:151``. Spot capacity is
``--spot`` (``--provisioning-model SPOT``), as on the pod.

Every verb takes ``--dry-run``, which prints the argv (one line a host)
instead of running it, so the commands can be checked, and copied, on a
machine with no ``gcloud``. A run across the group's hosts then starts one
process a host: ``parallel/launcher.py`` joins them from torchrun's
variables (``MASTER_ADDR`` the first host's internal address, which
``get_hosts`` writes into ``hosts``).

Usage:
    python -m ewdml_tpu_torch.tools.gpu_pod launch --name pod0 --count 2 \\
        --zone us-central1-a
    python -m ewdml_tpu_torch.tools.gpu_pod get_hosts --name pod0 --count 2
    python -m ewdml_tpu_torch.tools.gpu_pod run --name pod0 --command hostname
    python -m ewdml_tpu_torch.tools.gpu_pod kill_python --name pod0
    python -m ewdml_tpu_torch.tools.gpu_pod copy_code --name pod0 --src .
    python -m ewdml_tpu_torch.tools.gpu_pod terminate --name pod0
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import shlex
import subprocess
import sys
from typing import Optional

logger = logging.getLogger("ewdml_tpu_torch.tools.gpu_pod")


@dataclasses.dataclass
class PodConfig:
    """The group: ``count`` instances named ``<name>-<i>``."""

    name: str = "ewdml-pod"
    zone: str = "us-central1-a"
    project: Optional[str] = None
    count: int = 2
    machine_type: str = "a3-highgpu-1g"
    image_family: str = "common-cu128-ubuntu-2204-nvidia-570"
    image_project: str = "deeplearning-platform-release"
    spot: bool = False

    @property
    def hosts(self) -> list:
        return [f"{self.name}-{i}" for i in range(self.count)]


def _base() -> list:
    return ["gcloud", "compute"]


def _scope(cfg: PodConfig) -> list:
    out = ["--zone", cfg.zone]
    if cfg.project:
        out += ["--project", cfg.project]
    return out


def launch_cmd(cfg: PodConfig) -> list:
    """Create the group's instances (``launch_instances``)."""
    cmd = _base() + ["instances", "create", *cfg.hosts] + _scope(cfg) + [
        "--machine-type", cfg.machine_type,
        "--image-family", cfg.image_family,
        "--image-project", cfg.image_project,
        # A GPU instance cannot live-migrate.
        "--maintenance-policy", "TERMINATE",
    ]
    if cfg.spot:
        cmd += ["--provisioning-model", "SPOT"]
    return cmd


def terminate_cmd(cfg: PodConfig) -> list:
    """Delete the group's instances."""
    return _base() + ["instances", "delete", *cfg.hosts, "--quiet"] + \
        _scope(cfg)


def describe_cmd(cfg: PodConfig) -> list:
    """The group's instances as a JSON list (``check``,
    ``get_idle_instances``)."""
    cmd = _base() + ["instances", "list", "--filter",
                     f"name ~ ^{cfg.name}-[0-9]+$", "--zones",
                     cfg.zone, "--format", "json"]
    if cfg.project:
        cmd += ["--project", cfg.project]
    return cmd


def run_cmds(cfg: PodConfig, command: str) -> list:
    """``command`` on every host of the group (``run_command``): one
    ``gcloud compute ssh`` argv a host."""
    return [_base() + ["ssh", host] + _scope(cfg) + ["--command", command]
            for host in cfg.hosts]


def kill_python_cmds(cfg: PodConfig) -> list:
    """``kill_all_python`` / ``tools/killall.sh`` on every host."""
    return run_cmds(cfg, "pkill -f python || true")


def copy_code_cmds(cfg: PodConfig, src: str,
                   dst: str = "~/ewdml_tpu") -> list:
    """The code to every host (``tools/remote_script.sh``'s rsync loop)."""
    return [_base() + ["scp", "--recurse", src, f"{host}:{dst}"] +
            _scope(cfg) for host in cfg.hosts]


def parse_hosts(list_json: str) -> list:
    """Each instance's internal and external address from ``describe``'s
    JSON list (``get_hosts``; internal addresses first, as the reference
    prefers them, ``pytorch_ec2.py:682-683``), in host order."""
    def index(inst):
        tail = inst.get("name", "").rsplit("-", 1)[-1]
        return int(tail) if tail.isdigit() else 0

    hosts = []
    for inst in sorted(json.loads(list_json), key=index):
        nic = (inst.get("networkInterfaces") or [{}])[0]
        access = (nic.get("accessConfigs") or [{}])[0]
        hosts.append({"name": inst.get("name", ""),
                      "internal_ip": nic.get("networkIP", ""),
                      "external_ip": access.get("natIP", "")})
    return hosts


def write_hosts_files(hosts: list, prefix: str = "") -> None:
    """The ``hosts`` and ``hosts_alias`` files of the reference's launch
    scripts (``src/launch.sh:1-10``)."""
    with open(prefix + "hosts", "w") as f:
        for i, h in enumerate(hosts):
            f.write(f"{h['internal_ip']} worker{i}\n")
    with open(prefix + "hosts_alias", "w") as f:
        for h in hosts:
            f.write(f"{h['internal_ip']}\n")


def execute(cmd: list, dry_run: bool = False) -> str:
    """Run ``cmd`` and return its output; with ``dry_run`` return the
    argv as one shell-quoted line instead. Raises on a non-zero exit."""
    if dry_run:
        return shlex.join(cmd)
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {out.stderr.strip()}")
    return out.stdout


def execute_all(cmds: list, dry_run: bool = False) -> str:
    """Run every argv of ``cmds`` at once (the fan-out) and return their
    outputs in order, one after another; raises, naming the failed hosts'
    errors, if any exits non-zero. ``dry_run``: one line an argv."""
    if dry_run:
        return "\n".join(shlex.join(c) for c in cmds)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    failed = [f"{shlex.join(c)}: {err.strip()}"
              for c, p, (_, err) in zip(cmds, procs, outs) if p.returncode]
    if failed:
        raise RuntimeError(f"{cmds[0][0]} failed on {len(failed)} of "
                           f"{len(cmds)} hosts: " + "; ".join(failed))
    return "".join(out for out, _ in outs)


#: The verbs whose argv is one command for the whole group.
VERBS = {
    "launch": launch_cmd,
    "terminate": terminate_cmd,
    "describe": describe_cmd,
}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("verb", choices=list(VERBS) + [
        "run", "kill_python", "copy_code", "get_hosts"])
    p.add_argument("--name", default=PodConfig.name)
    p.add_argument("--zone", default=PodConfig.zone)
    p.add_argument("--project", default=None)
    p.add_argument("--count", type=int, default=PodConfig.count)
    p.add_argument("--machine-type", default=PodConfig.machine_type)
    p.add_argument("--image-family", default=PodConfig.image_family)
    p.add_argument("--image-project", default=PodConfig.image_project)
    p.add_argument("--spot", action="store_true")
    p.add_argument("--command", default="hostname")
    p.add_argument("--src", default=".")
    p.add_argument("--dry-run", action="store_true")
    ns = p.parse_args(argv)
    cfg = PodConfig(name=ns.name, zone=ns.zone, project=ns.project,
                    count=ns.count, machine_type=ns.machine_type,
                    image_family=ns.image_family,
                    image_project=ns.image_project, spot=ns.spot)
    if ns.verb == "get_hosts":
        out = execute(describe_cmd(cfg), ns.dry_run)
        if ns.dry_run:
            print(out)
            return 0
        hosts = parse_hosts(out)
        write_hosts_files(hosts)
        print(json.dumps(hosts, indent=2))
        return 0
    if ns.verb in VERBS:
        print(execute(VERBS[ns.verb](cfg), ns.dry_run))
        return 0
    cmds = {"run": lambda: run_cmds(cfg, ns.command),
            "kill_python": lambda: kill_python_cmds(cfg),
            "copy_code": lambda: copy_code_cmds(cfg, ns.src)}[ns.verb]()
    print(execute_all(cmds, ns.dry_run))
    return 0


if __name__ == "__main__":
    sys.exit(main())
