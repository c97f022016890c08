"""Cluster launchers (counterpart of the JAX package's `parallel/launch.py`,
after the reference's submitit launchers): on SLURM, write an sbatch script
that runs one task per GPU and `srun`s the same entry point, whose
`parallel/dist.py:init_distributed` then reads `SLURM_PROCID`,
`SLURM_NTASKS` and `SLURM_LOCALID`; the requeue of a preempted job is a
resume from the checkpoint in `--output_dir`. Elsewhere, run the entry
point in this process.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
from typing import List, Optional


def detect_cluster() -> str:
    """"slurm" inside a SLURM job, else "local". The JAX package's "tpu-pod"
    (a TPU pod's worker list) has no GPU counterpart."""
    if os.environ.get("SLURM_JOB_ID"):
        return "slurm"
    return "local"


def write_sbatch(script_path: str, entry: List[str], nodes: int = 1, gpus_per_node: int = 8,
                 timeout_min: int = 2800, partition: str = "learnlab",
                 job_name: str = "adaptersis", port: int = 29500) -> str:
    """An sbatch file of `nodes` × `gpus_per_node` tasks, one GPU each; the
    first node's host name and `port` are the rendezvous."""
    cmd = " ".join(shlex.quote(a) for a in [sys.executable] + entry)
    body = f"""#!/bin/bash
#SBATCH --job-name={job_name}
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node={gpus_per_node}
#SBATCH --gpus-per-node={gpus_per_node}
#SBATCH --cpus-per-task=10
#SBATCH --time={timeout_min}
#SBATCH --partition={partition}
#SBATCH --requeue
#SBATCH --open-mode=append
# one task per GPU; a requeue resumes from the checkpoint in --output_dir
export MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)
export MASTER_PORT={port}
srun --unbuffered {cmd}
"""
    with open(script_path, "w") as f:
        f.write(body)
    return script_path


def submit(entry: List[str], script_path: str = "adaptersis_submit.sh",
           **kw) -> Optional[str]:
    """sbatch `entry` on a SLURM cluster and return the job id (None if
    sbatch failed); elsewhere replace this process by `entry`."""
    if detect_cluster() == "slurm":
        path = write_sbatch(script_path, entry, **kw)
        out = subprocess.run(["sbatch", path], capture_output=True, text=True)
        print(out.stdout.strip())
        return out.stdout.strip().split()[-1] if out.returncode == 0 else None
    print(f"[launch] cluster=local; running inline: {' '.join(entry)}")
    os.execv(sys.executable, [sys.executable] + entry)
