"""The reference's training steps and the comparison that decides a
training cell's `correct`.

Adagrad with optax's semantics: the accumulator starts at 0.1 and takes
g²; a table the configuration updates sparsely ("sparse") divides by
√acc + 1e-7, every other leaf ("dense") multiplies by rsqrt(acc + 1e-7).
A row whose gradient is zero is left as it is by either rule, so the
dense reference step stands for the sparse touched-rows step.

The steps checked are 2K (K the steps of one dispatch), in two stages
of K: the first from the run's weights, the second from the program's
own state after the first K. A run at a large learning rate amplifies
round-off from step to step (c4's loss gap grows from 1e-7 to 6e-4 over
the second stage's eight steps on some seeds, on others not), so the
loss is compared where both sides start from the same state or close to
it: the first stage's steps and the second stage's first. The numbers
compared, each a worst case over those steps or the counted leaves:
  loss_gap    |loss_prog - loss_ref| / |loss_ref| at steps 1 .. K + 1;
  grad_gap    the first step's gradient, as its optimizer got it: by leaf,
              |‖g_prog‖ - ‖g_ref‖| / max(‖g_ref‖, median leaf's ‖g_ref‖);
              the program's g is worked out from its state after one step
              (p0, p1 and the accumulator a1);
  change_gap  the same gap of each stage's change ‖p_end - p_start‖.
A leaf whose reference gradient is under a thousandth of the median
leaf's (a bias that softmax cancels) moves by round-off alone and is not
counted; the rule reads the reference's gradient, never a name.

Plain PyTorch; imports nothing of the program."""

from __future__ import annotations

import statistics

import torch

INIT_ACC = 0.1
EPS = 1e-7
SKIP_BELOW = 1e-3


def run_steps(loss_fn, params: dict, acc: dict, batches: list, lr: float,
              rules: dict, dt: str):
    """The reference's steps from (params, acc), on copies: returns
    (losses, the first step's gradient norms by leaf, params and
    accumulators after the last step)."""
    p = {k: v.detach().clone() for k, v in params.items()}
    a = {k: v.detach().clone() for k, v in acc.items()}
    losses, first = [], None
    for batch in batches:
        live = {k: v.requires_grad_() for k, v in
                ((k, t.detach()) for k, t in p.items())}
        loss = loss_fn(live, batch, dt)
        grads = torch.autograd.grad(loss, list(live.values()))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: float(g.norm()) for k, g in zip(live, grads)}
        with torch.no_grad():
            for (k, t), g in zip(live.items(), grads):
                a[k].add_(g * g)
                if rules[k] == "sparse":
                    inv = 1.0 / (torch.sqrt(a[k]) + EPS)
                else:
                    inv = torch.rsqrt(a[k] + EPS)
                p[k] = (t - lr * g * inv).detach()
        del live, grads
    return losses, first, p, a


def gaps(loss_fn, p0: dict, batches: list, lr: float, rules: dict,
         prog: dict, dt: str = "bfloat16") -> dict:
    """The numbers compared, for a run that started from `p0` (every
    accumulator at INIT_ACC) and took len(batches) = 2K steps. `prog` is
    what the run under test left: "losses" (2K), "step1" and the states
    "K" and "2K", each {leaf: (param, accumulator)} on the device of p0.
    `dt` is the precision of the reference it is held against."""
    K = len(batches) // 2
    acc0 = {k: torch.full_like(v, INIT_ACC) for k, v in p0.items()}
    l1, g1, p1, _ = run_steps(loss_fn, p0, acc0, batches[:K], lr, rules, dt)
    del acc0
    mid = prog["K"]
    l2, _, p2, _ = run_steps(loss_fn, {k: v[0] for k, v in mid.items()},
                             {k: v[1] for k, v in mid.items()}, batches[K:],
                             lr, rules, dt)
    leaves = counted(g1)
    prog_g = {k: grad_from_state(p0[k], p, a, lr, rules[k])
              for k, (p, a) in prog["step1"].items()}

    def change(a, b):
        return float((a - b).norm())
    end = prog["2K"]
    first = leaf_gap({k: change(mid[k][0], p0[k]) for k in p0},
                     {k: change(p1[k], p0[k]) for k in p0}, leaves)[0]
    second = leaf_gap({k: change(end[k][0], mid[k][0]) for k in p0},
                      {k: change(p2[k], mid[k][0]) for k in p0}, leaves)[0]
    ref = l1 + l2
    return {"loss_gap": loss_gap(prog["losses"][:K + 1], ref[:K + 1]),
            "grad_gap": leaf_gap(prog_g, g1, leaves)[0],
            "change_gap": max(first, second),
            "stage_change_gaps": [first, second],
            "skipped": sorted(set(g1) - set(leaves)),
            "step_gaps": [abs(a - b) / abs(b)
                          for a, b in zip(prog["losses"], ref)]}


def grad_from_state(p0, p1, a1, lr: float, rule: str) -> float:
    """‖g‖ of the first step from the parameters before and after it and
    the accumulator after it."""
    d = (p0.float() - p1.float())
    if rule == "sparse":
        g = d * (torch.sqrt(a1.float()) + EPS) / lr
    else:
        g = d * torch.sqrt(a1.float() + EPS) / lr
    return float(g.norm())


def counted(ref_grads: dict) -> list[str]:
    med = statistics.median(ref_grads.values())
    return [k for k, n in ref_grads.items() if n >= SKIP_BELOW * med]


def leaf_gap(prog: dict, ref: dict, leaves: list[str]) -> tuple[float, str]:
    """(worst gap, its leaf) of per-leaf norms, each against
    max(the reference's norm, the median leaf's)."""
    med = statistics.median(ref[k] for k in leaves)
    worst = max(leaves, key=lambda k: abs(prog[k] - ref[k])
                / max(ref[k], med))
    return abs(prog[worst] - ref[worst]) / max(ref[worst], med), worst


def loss_gap(prog: list, ref: list) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))
