"""Two-rank runs of the port for the data-parallel and distributed-eval
tests, on the CPU over gloo: `spawn` starts W processes of this file with
torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), each running one
job on the inputs the test wrote, and fails a test whose ranks do not end
inside their time limit. The jobs import torch and the port only (no jax),
run on one intra-op thread, and write their results with torch.save.

    python tests/torch_dist.py <job> <directory>
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(job: str, directory, world_size: int = 2, extra_env: Dict[str, str] = None
          ) -> List[subprocess.Popen]:
    """Start the job's ranks; `wait` collects them."""
    port = free_port()
    procs = []
    for rank in range(world_size):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world_size),
               "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep.join(
                   [str(REPO), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")])}
        env.update(extra_env or {})
        log = open(Path(directory) / f"{job}.rank{rank}.log", "w")
        procs.append(subprocess.Popen([sys.executable, str(Path(__file__)), job, str(directory)],
                                      env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
    return procs


def wait(procs: List[subprocess.Popen], directory, job: str, timeout: float) -> None:
    """Wait for every rank, at most `timeout` seconds in all; kill them all
    and fail with the ranks' logs when one fails or the time runs out."""
    import time

    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    failed = [p for p in procs if p.poll() is None or p.returncode != 0]
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if failed:
        logs = "\n".join((Path(directory) / f"{job}.rank{r}.log").read_text()[-3000:]
                         for r in range(len(procs)))
        raise AssertionError(f"job {job}: a rank failed or outlived {timeout} s\n{logs}")


def spawn(job: str, directory, world_size: int = 2, timeout: float = 120.0,
          extra_env: Dict[str, str] = None) -> None:
    wait(start(job, directory, world_size, extra_env), directory, job, timeout)


# ---- the jobs (run inside the ranks) ----

def rows(n: int, rank: int, world_size: int) -> np.ndarray:
    """A rank's rows of a global batch of n: rank, rank + W, ..."""
    return np.arange(rank, n, world_size)


def crop_rows(n_images: int, n_crops: int, rank: int, world_size: int) -> np.ndarray:
    """A rank's rows of a crop-major stack [crop 0 of the n images; crop 1;
    ...]: its images' rows in every crop."""
    mine = rows(n_images, rank, world_size)
    return np.concatenate([j * n_images + mine for j in range(n_crops)])


def _named_grads(module) -> Dict[str, torch.Tensor]:
    from adaptersis_tpu_torch.parallel.mesh import full

    return {k: full(p.grad).clone() for k, p in module.named_parameters() if p.grad is not None}


def _whole_state(module) -> Dict[str, torch.Tensor]:
    from adaptersis_tpu_torch.parallel.mesh import full_tree

    return {k: v.clone() for k, v in full_tree(module.state_dict()).items()}


def job_bn(directory: Path, rank: int, W: int) -> dict:
    """The global BatchNorm's training forward and backward on this rank's
    rows of the global batch; then a MetricLogger's meters synchronised
    over the ranks and its rank-0 output file."""
    from adaptersis_tpu_torch.models.encoders import BatchNorm2d

    inp = torch.load(directory / "bn_in.pt")
    mine = torch.from_numpy(rows(inp["x"].shape[0], rank, W))
    bn = BatchNorm2d(inp["x"].shape[1])
    bn.load_state_dict(inp["state"])
    bn.train()
    x = inp["x"][mine].clone().requires_grad_()
    y = bn(x)
    (y * inp["w"][mine]).sum().backward()
    from adaptersis_tpu_torch.utils.logging import MetricLogger

    logger = MetricLogger(output_file=str(directory / "metrics.jsonl"))
    for i in range(rank + 2):                 # rank r logs r + 2 values
        logger.update(n=i + 1, loss=float(rank * 10 + i))
    logger.dump_in_output_file(0, 0.1, 0.01)
    logger.synchronize_between_processes()
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone(),
            "loss_meter": (logger.loss.count, logger.loss.total, logger.loss.global_avg)}


def _adapter_model(cfg: dict):
    from adaptersis_tpu_torch.models.segmentor import AdapterSegmentor
    from adaptersis_tpu_torch.models.vit import DinoVisionTransformer

    return AdapterSegmentor(DinoVisionTransformer(gelu_approx=True, **cfg["vit"]), **cfg["head"])


def job_step(directory: Path, rank: int, W: int) -> dict:
    """One float64 adapter train step at --fsdp 1 and 2 from the same
    weights, each rank on its rows; then the validation metrics of a
    seeded 3-class model over a set that W does not divide."""
    from adaptersis_tpu_torch import evaluate
    from adaptersis_tpu_torch.parallel.mesh import get_mesh
    from adaptersis_tpu_torch.train.trainer import Trainer

    inp = torch.load(directory / "step_in.pt")
    mine = torch.from_numpy(rows(inp["x"].shape[0], rank, W))
    out = {}
    for fsdp in (1, 2):
        model = _adapter_model(inp["cfg"]).double()
        model.load_state_dict(inp["state"])
        trainer = Trainer(model, lr=inp["lr"], epochs=inp["epochs"],
                          mesh=get_mesh(fsdp, "cpu"))
        loss = trainer.step(inp["x"][mine], inp["y"][mine], 0)
        out[fsdp] = {"loss": float(loss), "grads": _named_grads(model),
                     "state": _whole_state(model)}
    out["val"] = evaluate.main(inp["val_argv"])
    return out


def job_train_seg(directory: Path, rank: int, W: int) -> dict:
    """train_seg's CLI at W ranks, --fsdp 2: two epochs, and the same run
    stopped after one (its checkpoint is resumed at W = 1 by the test)."""
    from adaptersis_tpu_torch import train_seg

    argv = (directory / "train_seg_argv.txt").read_text().split()
    full = train_seg.main(argv + ["--output_dir", str(directory / "full")])
    os.environ["ASN_STOP_AFTER_EPOCHS"] = "1"
    stopped = train_seg.main(argv + ["--output_dir", str(directory / "stopped")])
    return {"full": full, "stopped": stopped}


def job_ete_state(directory: Path, rank: int, W: int) -> dict:
    """A tap_setr_ete trainer (its backbone trained, so sharded by FSDP2,
    with sharded momentum buffers) at --fsdp 2: one step, its whole state
    saved, a fresh trainer loading it, its state again; then the state
    file written at W = 1 loaded at W = 2."""
    from adaptersis_tpu_torch.models.layers import TRAINED
    from adaptersis_tpu_torch.models.tap_segmentor import TapSegmentor
    from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
    from adaptersis_tpu_torch.parallel.mesh import get_mesh
    from adaptersis_tpu_torch.train.trainer import Trainer

    inp = torch.load(directory / "ete_in.pt")
    impls = dict(zip(("attn_impl", "ln_impl", "qkv_impl", "mlp_impl"), TRAINED))

    def trainer():
        torch.manual_seed(0)
        model = TapSegmentor(DinoVisionTransformer(gelu_approx=True, **impls, **inp["vit"]),
                             num_classes=2, decoder="setr_ete")
        return Trainer(model, lr=0.05, epochs=4, loss="ce_dc", softmax=False,
                       mesh=get_mesh(2, "cpu"))

    mine = torch.from_numpy(rows(inp["x"].shape[0], rank, W))
    first = trainer()
    first.step(inp["x"][mine], inp["y"][mine], 0)
    saved = first.state_dict()
    second = trainer()
    second.load_state_dict(saved)
    third = trainer()
    third.load_state_dict(torch.load(directory / "ete_w1.pt"))
    return {"saved": saved, "reloaded": second.state_dict(), "from_w1": third.state_dict()}


def job_ssl(directory: Path, rank: int, W: int) -> dict:
    """sinkhorn_knopp on this rank's rows, then two SSL steps in each mask
    form (gathered at --fsdp 1, bool at --fsdp 2) from the same state: the
    losses of both, the second step's gradients, the state after it."""
    from adaptersis_tpu_torch.models.layers import TRAINED
    from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
    from adaptersis_tpu_torch.parallel.mesh import full
    from adaptersis_tpu_torch.parallel.mesh import get_mesh
    from adaptersis_tpu_torch.ssl.losses import sinkhorn_knopp
    from adaptersis_tpu_torch.ssl.masking import MaskInfo, rank_masks
    from adaptersis_tpu_torch.ssl.meta_arch import SSLConfig, SSLMetaArch, masks_to

    inp = torch.load(directory / "ssl_in.pt", weights_only=False)
    t = inp["sinkhorn"]
    out = {"sinkhorn": sinkhorn_knopp(t[torch.from_numpy(rows(t.shape[0], rank, W))], 0.05)}
    impls = dict(zip(("attn_impl", "ln_impl", "qkv_impl", "mlp_impl"), TRAINED))
    B = inp["B"]
    g = inp["g"][torch.from_numpy(crop_rows(B, 2, rank, W))]
    n_local = inp["l"].shape[0] // B
    l = inp["l"][torch.from_numpy(crop_rows(B, n_local, rank, W))]
    info = MaskInfo(*inp["info"])
    n_tokens = info.masks.shape[1]
    for form, fsdp in (("gathered", 1), ("bool", 2)):
        arch = SSLMetaArch(DinoVisionTransformer(**impls, **inp["vit"]),
                           SSLConfig(**inp["heads"]))
        arch.load_state_dict(inp["state"])
        arch.shard(get_mesh(fsdp, "cpu"))
        if form == "gathered":
            masks = masks_to(rank_masks(info, n_tokens, rank, W), torch.device("cpu"))
        else:
            masks = torch.from_numpy(info.masks[crop_rows(B, 2, rank, W)])
        losses = [{k: float(v) for k, v in arch.train_step(g, l, masks, **inp["sched"]).items()}
                  for _ in range(2)]
        out[form] = {"losses": losses, "grads": _named_grads(arch.student),
                     "state": _whole_state(arch),
                     "mu": [full(m) for m in arch.checkpoint_state()["mu"]]}
    return out


class _Frames:
    """Items (uint8 frame, label, index) of a stack of frames."""

    def __init__(self, imgs: np.ndarray, labels: np.ndarray):
        self.imgs, self.labels = imgs, labels

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return self.imgs[i], int(self.labels[i]), i


def job_evals(directory: Path, rank: int, W: int) -> dict:
    """knn_classify with the train rows split over the ranks (their count
    odd), then extract_features over this rank's shard of the frames (an
    unshuffled EpochSampler that pads the last shard), gathered; and
    all_gather_rows of rank + 1 rows a rank (10·rank + i)."""
    from adaptersis_tpu_torch.data.loader import DataLoader
    from adaptersis_tpu_torch.data.samplers import EpochSampler
    from adaptersis_tpu_torch.evals import ModelWithIntermediateLayers, extract_features
    from adaptersis_tpu_torch.evals.knn import knn_classify
    from adaptersis_tpu_torch.models.vit import DinoVisionTransformer
    from adaptersis_tpu_torch.parallel.dist import all_gather_rows

    inp = torch.load(directory / "evals_in.pt", weights_only=False)
    out = {k: knn_classify(inp["train"], inp["train_y"], inp["test"], inp["classes"], k=k,
                           test_chunk=inp["chunk"]) for k in inp["ks"]}
    vit = DinoVisionTransformer(**inp["vit"])
    vit.load_state_dict(inp["state"])
    ds = _Frames(inp["imgs"], inp["labels"])
    loader = DataLoader(ds, EpochSampler(len(ds), shuffle=False, rank=rank, world_size=W,
                                         drop_last=False), batch_size=2, drop_last=False)
    out["features"], out["labels"] = extract_features(
        ModelWithIntermediateLayers(vit.eval(), inp["n_last_blocks"]), loader)
    out["uneven"] = all_gather_rows(10 * rank + torch.arange(rank + 1)[:, None].repeat(1, 3))
    return out


JOBS = {"bn": job_bn, "step": job_step, "train_seg": job_train_seg, "ete_state": job_ete_state,
        "ssl": job_ssl, "evals": job_evals}


def main(job: str, directory: str) -> None:
    torch.set_num_threads(1)
    from adaptersis_tpu_torch.parallel.dist import get_rank, get_world_size, init_distributed

    init_distributed("env://", "cpu")
    rank, W = get_rank(), get_world_size()
    assert W == int(os.environ["WORLD_SIZE"]) > 1
    result = JOBS[job](Path(directory), rank, W)
    torch.save(result, Path(directory) / f"{job}.out{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
