"""The comparison that decides a serving cell's `correct`.

For each checked request the reference scores every item itself (its own
query encode, its own item latents, the configuration's precision), sets
the request's seen items to -inf and takes its k-th best score. Each
served id's gap is how far the reference's score of it lies below that
k-th best, as a share of the spread (standard deviation) of the row's
scores; a served list that repeats an id, holds an id outside the
vocabulary or a seen one reads inf. The number compared, `score_gap`, is
the widest gap over the checked requests: exact answers read 0 up to ties
and rounding.

Plain PyTorch; imports nothing of the program."""

from __future__ import annotations

import torch

from reference.model import scores


def score_gaps(q, v, b, seen: list, served: torch.Tensor, dt: str,
               block: int = 256) -> torch.Tensor:
    """[n] widest gap of each request's served ids. q [n, D]; seen: n
    lists of item ids; served [n, k] int."""
    n, k = served.shape
    V = v.shape[0]
    out = torch.empty(n, device=q.device)
    for s in range(0, n, block):
        sc = scores(q[s:s + block], v, b, dt)
        rows = torch.arange(sc.shape[0], device=q.device)
        for i, ids in enumerate(seen[s:s + block]):
            if len(ids):
                sc[i, torch.as_tensor(ids, device=q.device).long()] = (
                    -float("inf"))
        spread = torch.where(torch.isfinite(sc), sc, torch.nan)
        spread = (spread - spread.nanmean(1, keepdim=True)).pow(2)
        spread = spread.nanmean(1).sqrt()
        kth = torch.topk(sc, k, dim=1).values[:, -1]
        got = served[s:s + block].to(q.device).long()
        bad = ((got < 0) | (got >= V)).any(1)
        picked = sc[rows[:, None], got.clamp(0, V - 1)]
        gap = ((kth[:, None] - picked).clamp_min(0).amax(1) / spread)
        dup = torch.tensor([len(set(r.tolist())) < k for r in got],
                           device=q.device)
        bad |= dup | ~torch.isfinite(picked).all(1)
        out[s:s + block] = torch.where(bad, float("inf"), gap)
    return out
