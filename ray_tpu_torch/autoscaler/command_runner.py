"""Command runners: how the launcher reaches cluster nodes.

Reference: `python/ray/autoscaler/_private/command_runner.py`
(`SSHCommandRunner`, `DockerCommandRunner`) — the seam `ray attach` /
`ray exec` / file sync run through.  The runner is injectable so the
whole attach/exec flow is testable against a mock, and alternative
transports (gcloud tpu-vm ssh, kubectl exec) slot in without touching
the command layer.
"""

from __future__ import annotations

import subprocess
from typing import Any, Dict, List, Optional, Tuple


class CommandRunner:
    """One node's command channel."""

    def run(self, cmd: str, *, timeout: Optional[float] = None,
            ) -> Tuple[int, str]:
        """Run `cmd` on the node; returns (returncode, combined output)."""
        raise NotImplementedError

    def run_interactive(self, cmd: str = "bash") -> int:
        """Attach an interactive session (inherits this process's tty);
        returns the exit code."""
        raise NotImplementedError

    def remote_shell_command(self, cmd: str = "") -> List[str]:
        """The argv a user could run by hand to reach the node (printed
        by `rt attach` so the session is reproducible without the CLI)."""
        raise NotImplementedError


class SSHCommandRunner(CommandRunner):
    """Plain ssh (reference: `command_runner.py` SSHCommandRunner).

    auth fields come from the cluster YAML's `auth:` section:
    ssh_user, ssh_private_key (optional), ssh_options (list).
    """

    def __init__(self, ip: str, *, ssh_user: str = "ubuntu",
                 ssh_private_key: Optional[str] = None,
                 ssh_options: Optional[List[str]] = None):
        self.ip = ip
        self.user = ssh_user
        self.key = ssh_private_key
        self.options = list(ssh_options or (
            "-o", "StrictHostKeyChecking=no",
            "-o", "ConnectTimeout=10",
        ))

    def _base(self) -> List[str]:
        argv = ["ssh", *self.options]
        if self.key:
            argv += ["-i", self.key]
        argv.append(f"{self.user}@{self.ip}")
        return argv

    def remote_shell_command(self, cmd: str = "") -> List[str]:
        argv = self._base()
        if cmd:
            argv.append(cmd)
        return argv

    def run(self, cmd: str, *, timeout: Optional[float] = None):
        proc = subprocess.run(
            self.remote_shell_command(cmd),
            capture_output=True, text=True, timeout=timeout,
        )
        return proc.returncode, proc.stdout + proc.stderr

    def run_interactive(self, cmd: str = "bash") -> int:
        argv = self._base()
        argv += ["-t", cmd]
        return subprocess.call(argv)


class DockerCommandRunner(SSHCommandRunner):
    """ssh + `docker exec` into a named container (reference:
    `command_runner.py` DockerCommandRunner): commands run INSIDE the
    container the cluster processes live in."""

    def __init__(self, ip: str, *, container: str, **ssh_kwargs):
        super().__init__(ip, **ssh_kwargs)
        self.container = container

    def _wrap(self, cmd: str, interactive: bool = False) -> str:
        import shlex

        parts = ["docker", "exec"]
        if interactive:
            parts.append("-it")
        parts += [self.container, "/bin/bash", "-lc", shlex.quote(cmd)]
        return " ".join(parts)

    def run(self, cmd: str, *, timeout: Optional[float] = None):
        return super().run(self._wrap(cmd), timeout=timeout)

    def run_interactive(self, cmd: str = "bash") -> int:
        return super().run_interactive(self._wrap(cmd, interactive=True))


def runner_for(cfg: Dict[str, Any], ip: str) -> CommandRunner:
    """Build the configured runner for one node ip from the cluster
    YAML (`auth:` + optional `docker:` sections)."""
    auth = cfg.get("auth", {})
    kwargs = {
        "ssh_user": auth.get("ssh_user", "ubuntu"),
        "ssh_private_key": auth.get("ssh_private_key"),
    }
    if auth.get("ssh_options"):
        kwargs["ssh_options"] = list(auth["ssh_options"])
    docker = cfg.get("docker", {})
    if docker.get("container_name"):
        return DockerCommandRunner(
            ip, container=docker["container_name"], **kwargs
        )
    return SSHCommandRunner(ip, **kwargs)
