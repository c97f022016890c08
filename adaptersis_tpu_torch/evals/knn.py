"""k-NN classification on frozen features (counterpart of the JAX package's
`evals/knn.py`, DINOv2's `eval/knn.py`).

The similarities are computed in test chunks of `test_chunk` rows, so no
more than a (chunk, N) slab is alive at once; each chunk keeps its top k
and votes with softmax(similarity / T) weights. With several ranks the
train rows are split into W equal blocks (the last padded): each rank
takes its block's top k per test row, the (chunk, k·W) candidates are
gathered and the global top k selected again, so a rank holds O(chunk ·
N/W) similarities. Padded rows take −inf similarity, as the JAX
validity mask gives them.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..parallel.dist import all_gather_with_grad, get_rank, get_world_size


def _vote(topv: torch.Tensor, topy: torch.Tensor, num_classes: int, T: float) -> torch.Tensor:
    w = torch.exp(topv / T)
    return torch.einsum("mk,mkc->mc", w, F.one_hot(topy.long(), num_classes).to(w.dtype))


def _gather_candidates(v: torch.Tensor, y: torch.Tensor):
    """(chunk, k) per rank → (chunk, k·W), rank blocks side by side."""
    m = v.shape[0]
    return tuple(all_gather_with_grad(t).permute(1, 0, 2).reshape(m, -1) for t in (v, y))


def knn_classify(train_features: torch.Tensor, train_labels: torch.Tensor,
                 test_features: torch.Tensor, num_classes: int, k: int = 10,
                 T: float = 0.07, normalize: bool = True,
                 test_chunk: int = 1024) -> torch.Tensor:
    """(M, num_classes) class scores of the test rows. Every rank passes the
    whole train and test sets; with several ranks each reads its block of
    the train rows only."""
    if normalize:
        train_features = train_features / torch.linalg.norm(train_features, dim=-1,
                                                            keepdim=True)
        test_features = test_features / torch.linalg.norm(test_features, dim=-1, keepdim=True)
    W = get_world_size()
    N = train_features.shape[0]
    if W > 1:
        per = -(-N // W)
        lo = min(get_rank() * per, N)
        train_features, train_labels = train_features[lo:lo + per], train_labels[lo:lo + per]
        valid = train_features.shape[0]
        pad = per - valid
        if pad:
            train_features = F.pad(train_features, (0, 0, 0, pad))
            train_labels = F.pad(train_labels, (0, pad))
    M = test_features.shape[0]
    cm = min(test_chunk, M)
    scores = []
    for start in range(0, M, cm):
        sim = test_features[start:start + cm] @ train_features.t()    # (cm, N/W): the bound
        if W > 1 and pad:
            sim[:, valid:] = -torch.inf
        topv, topi = torch.topk(sim, k, dim=1)
        topy = train_labels[topi]
        del sim
        if W > 1:
            allv, ally = _gather_candidates(topv, topy)
            topv, gi = torch.topk(allv, k, dim=1)
            topy = torch.gather(ally, 1, gi)
        scores.append(_vote(topv, topy, num_classes, T))
    return torch.cat(scores)


def eval_knn(train_features, train_labels, test_features, test_labels, num_classes: int,
             nb_knn: Sequence[int] = (10, 20, 100, 200), T: float = 0.07,
             test_chunk: int = 1024) -> dict:
    """{k: accuracy} for each k of `nb_knn`. The rows are L2-normalised
    once, not once per k: one normalised copy of the features is alive."""
    out = {}
    test_labels = torch.as_tensor(test_labels)
    train_features, test_features = (
        f / torch.linalg.norm(f, dim=-1, keepdim=True)
        for f in (torch.as_tensor(train_features), torch.as_tensor(test_features)))
    for k in nb_knn:
        scores = knn_classify(train_features, torch.as_tensor(train_labels), test_features,
                              num_classes, k=k, T=T, normalize=False, test_chunk=test_chunk)
        out[k] = (scores.argmax(-1) == test_labels.to(scores.device)).float().mean().item()
    return out
