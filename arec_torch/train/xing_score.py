"""XING RecSys Challenge 2017 leaderboard score (the port's copy of
`arec/train/xing_score.py`, pure Python).

Rebuild of the reference's challenge-evaluation path (SURVEY.md §2.1
"Evaluation": "for XING also the RecSys'17 leaderboard score and a
submission-file writer"). The submission writer lives in
Trainer.recommend(out_path=...); this module scores a set of
recommendations against observed interactions.

Scoring structure (challenge definition; exact coefficients are the
published 2017 ones to the best of available knowledge — the reference
mount and the challenge site are unreachable from this machine, so the
weights are parameters with these defaults rather than hard-coded):

  user_success(u, i) =
      premium_boost(u) · [ w_click·clicked + w_bm_reply·(bookmarked or
      replied) + w_recruiter·recruiter_interest ]  −  w_delete·deleted_only
  item_success(i) = w_item_paid if i is a paid item and some pushed user
      interacted positively, else w_item_free (awarded once per item)
  leaderboard = Σ_items [ item_success(i) + Σ_users user_success(u, i) ]

Interaction types follow the challenge dump: 1 click, 2 bookmark,
3 reply, 4 delete, 5 recruiter interest.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class XingWeights:
    click: float = 1.0
    bookmark_reply: float = 5.0
    recruiter: float = 20.0
    delete: float = 10.0
    premium_boost: float = 2.0
    item_paid: float = 50.0
    item_free: float = 25.0


def leaderboard_score(
    recommendations: dict[int, list[int]],
    interactions: list[tuple[int, int, int]],   # (user, item, type)
    premium_users: set[int],
    paid_items: set[int],
    weights: XingWeights = XingWeights(),
) -> float:
    """Score pushed recommendations against observed interactions."""
    by_pair: dict[tuple[int, int], set[int]] = {}
    for u, i, t in interactions:
        by_pair.setdefault((u, i), set()).add(t)

    total = 0.0
    item_succeeded: set[int] = set()
    for u, items in recommendations.items():
        for i in items:
            types = by_pair.get((u, i))
            if not types:
                continue
            positive = (weights.click * (1 in types)
                        + weights.bookmark_reply * bool(types & {2, 3})
                        + weights.recruiter * (5 in types))
            if positive > 0:
                boost = weights.premium_boost if u in premium_users else 1.0
                total += boost * positive
                item_succeeded.add(i)
            elif 4 in types:
                total -= weights.delete
    for i in item_succeeded:
        total += (weights.item_paid if i in paid_items
                  else weights.item_free)
    return total


def read_submission(path: str) -> dict[int, list[int]]:
    """Parse the Trainer.recommend submission format: `user\\tid,id,...`."""
    out: dict[int, list[int]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            u, _, items = line.partition("\t")
            out[int(u)] = [int(x) for x in items.split(",") if x]
    return out
