"""Subprocess jobs of the port's tests: commands started all at once, each
writing its output to files in the caller's directory, so independent
runs of whole scripts (the examples, the paper tables of each package)
share the machine's cores instead of queueing. Each job runs with ``src``,
the repository's root and ``tests`` on its path, JAX on the CPU and one
intra-op thread."""
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def job_env():
    path = [str(ROOT / "src"), str(ROOT), str(ROOT / "tests")]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(path), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


class Job:
    """One command, started at construction in ``cwd``."""

    def __init__(self, name, argv, cwd):
        self.name, self.cwd = name, Path(cwd)
        self._out = open(self.cwd / f"{name}.stdout", "w")
        self._err = open(self.cwd / f"{name}.stderr", "w")
        self.proc = subprocess.Popen([sys.executable, *map(str, argv)], cwd=self.cwd,
                                     env=job_env(), stdout=self._out, stderr=self._err)

    def stop(self):
        """Kills the command if it still runs."""
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._out.close()
        self._err.close()

    def wait(self, timeout):
        """(exit code, stdout, stderr) once the command has ended."""
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            self.stop()
        return (rc, (self.cwd / f"{self.name}.stdout").read_text(),
                (self.cwd / f"{self.name}.stderr").read_text())


def run_all(jobs, timeout):
    """Waits for every job (started together) until ``timeout`` seconds
    from now, killing what is left at the first failure to end in time;
    returns name -> (rc, out, err)."""
    deadline = time.monotonic() + timeout
    try:
        return {job.name: job.wait(max(deadline - time.monotonic(), 1.0)) for job in jobs}
    finally:
        for job in jobs:
            job.stop()
