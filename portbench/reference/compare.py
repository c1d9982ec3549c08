"""The comparison that decides a training cell's ``correct``: the readings
of the program's first steps against the reference's.

* ``grad_median_gap``: the median over the leaves of the gap between the
  norm of the program's first gradient and the reference's, each over the
  larger of that leaf's reference norm and the median leaf's;
* ``delta_median_gap``: the same for each leaf's change over the steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by round-off alone);
* ``ema_delta_median_gap``: the same for each leaf's change in the EMA
  encoder, over the leaves whose starting weights differ between the two
  encoders (the others, BN scales and biases drawn as constants in both,
  move in the EMA by round-off alone);
* ``keys_gap``: the largest absolute difference between the key rows the
  steps put into the MoCo queue;
* ``stem_var_gap``: the largest relative difference, over the channels of
  both encoders, between the batch variances that the stem's BN (its module
  path given by the configuration) took into its running variance in the
  first step: the augmentation and the stem convolution, before the depth of
  the network amplifies rounding;
* ``bn_var_median_gap``: over the BNs whose module paths start with one of
  the configuration's ``bn_checked`` prefixes, the median of each BN's
  median relative gap over its channels (the worse encoder's) between the
  same first-step batch variances: the precision of the layers past the
  stem, as deep as rounding stays below the control's.

The worst leaf's gaps and the loss gap are readings beside them
(:func:`diagnostics`): at initialisation, train-mode BN through the depth of
the network and the softmax Jacobian of the graph blocks carry any rounding
far enough that those read alike in bfloat16 and in float8.  A reading that
is missing, of another shape, or not finite makes its number infinite.
"""

from __future__ import annotations

import math
import statistics

import torch

NUMBERS = ("grad_median_gap", "delta_median_gap", "ema_delta_median_gap", "keys_gap",
           "stem_var_gap", "bn_var_median_gap")
QUIET_LEAF = 1e-3


def _finite(x: float) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def worst_leaf(prog: dict, ref: dict, leaves) -> tuple:
    """(gap, leaf) of the largest norm gap over ``leaves``."""
    leaves = list(leaves)
    floor = statistics.median(ref[n] for n in leaves)
    worst, name = 0.0, None
    for n in leaves:
        if n not in prog or not _finite(prog[n]):
            return math.inf, n
        gap = abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30)
        if gap > worst:
            worst, name = gap, n
    return worst, name


def moved_leaves(ref_grad: dict, ref_delta: dict) -> list:
    """The leaves of ``ref_delta`` whose reference gradient is at least a
    thousandth of the median leaf's."""
    floor = QUIET_LEAF * statistics.median(ref_grad.values())
    return [n for n in ref_delta if ref_grad[n] >= floor]


def batch_variance(running_var: torch.Tensor, momentum: float) -> torch.Tensor:
    """The batch variance a first BN update took into a running variance
    that started at 1."""
    return (running_var.double() - momentum) / (1.0 - momentum)


def apart_leaves(ref: dict) -> list:
    """The leaves whose starting weights differ between the two encoders."""
    return [n for n, d in ref["ema_apart"].items() if d > 0]


def bn_var_gap(prog: dict, ref: dict, enc: str, name: str):
    """Per-channel relative gap between the batch variances that BN ``name``
    of encoder ``enc`` took in the first step; None where the program's
    reading is missing or misshapen."""
    m = ref["bn_momentum"]
    got = ((prog.get("bn") or {}).get(enc) or {}).get(name)
    want = batch_variance(ref["bn"][enc][name], m)
    if got is None or got.shape != want.shape:
        return None
    return (batch_variance(got, m) - want).abs() / want.abs()


def bn_var_median(prog: dict, ref: dict, prefixes) -> tuple:
    """(value, where) of ``bn_var_median_gap``."""
    names = [n for n in ref["bn"]["model"] if any(n.startswith(p) for p in prefixes)]
    if not names:
        return math.inf, "no BN matches bn_checked"
    per_bn = []
    for n in names:
        gaps = [bn_var_gap(prog, ref, enc, n) for enc in ("model", "ema")]
        if any(g is None for g in gaps):
            return math.inf, f"{n}: missing"
        per_bn.append(max(float(g.median()) for g in gaps))
    worst = max(range(len(names)), key=per_bn.__getitem__)
    return statistics.median(per_bn), f"median of {len(names)} BNs; worst {names[worst]}"


def compare(prog: dict, ref: dict, config: dict) -> dict:
    """name -> (value, where) for each of :data:`NUMBERS`; ``config`` is the
    configuration's file: ``stem_bn``, the module path of the stem's BN, and
    ``bn_checked``, the module-path prefixes of the BNs of
    ``bn_var_median_gap``."""
    out = {}
    grad = prog.get("grad") or {}
    out["grad_median_gap"] = (median_leaf(grad, ref["grad"], ref["grad"]), "median leaf")
    out["delta_median_gap"] = (median_leaf(prog.get("delta") or {}, ref["delta"],
                                           moved_leaves(ref["grad"], ref["delta"])),
                               "median moved leaf")
    out["ema_delta_median_gap"] = (median_leaf(prog.get("ema_delta") or {}, ref["ema_delta"],
                                               apart_leaves(ref)), "median EMA leaf")
    pk, rk = prog.get("keys"), ref["keys"]
    if pk is None or tuple(pk.shape) != tuple(rk.shape) or not bool(torch.isfinite(pk).all()):
        out["keys_gap"] = (math.inf, "missing, misshapen or non-finite keys")
    else:
        diff = (pk.double() - rk.double()).abs()
        out["keys_gap"] = (float(diff.max()), f"row {int(diff.amax(dim=1).argmax())}")
    worst, where = 0.0, "no stem reading"
    for enc in ("model", "ema"):
        gap = bn_var_gap(prog, ref, enc, config["stem_bn"])
        if gap is None:
            worst, where = math.inf, f"{enc}: missing"
            break
        if float(gap.max()) > worst or not math.isfinite(float(gap.max())):
            worst, where = float(gap.max()), f"{enc} channel {int(gap.argmax())}"
    out["stem_var_gap"] = (worst, where)
    out["bn_var_median_gap"] = bn_var_median(prog, ref, config["bn_checked"])
    return out


def median_leaf(prog: dict, ref: dict, leaves) -> float:
    """The median over ``leaves`` of the per-leaf norm gap (each over the
    larger of its reference norm and the median leaf's)."""
    leaves = list(leaves)
    floor = statistics.median(ref[n] for n in leaves)
    if not all(n in prog and _finite(prog[n]) for n in leaves):
        return math.inf
    return statistics.median(abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in leaves)


def diagnostics(prog: dict, ref: dict) -> dict:
    """Readings beside :func:`compare`'s numbers: the worst leaf's gradient,
    change and EMA change gaps, the loss gap over the steps and at the first, the keys'
    relative gaps, the global gradient norm's gap."""
    b = ref["keys"].shape[0] // len(ref["loss"])
    pk = prog.get("keys")
    rk = ref["keys"].double()

    def rel(a, r):
        return float((a.double() - r).norm() / r.norm())

    grads = [n for n in ref["grad"] if n in (prog.get("grad") or {})]
    losses = list(zip(prog.get("loss", []), ref["loss"]))
    return {
        "grad_gap": worst_leaf(prog.get("grad") or {}, ref["grad"], ref["grad"])[0],
        "delta_gap": worst_leaf(prog.get("delta") or {}, ref["delta"],
                                moved_leaves(ref["grad"], ref["delta"]))[0],
        "ema_delta_gap": worst_leaf(prog.get("ema_delta") or {}, ref["ema_delta"],
                                    apart_leaves(ref))[0],
        "loss_gap": max(abs(p - r) / abs(r) for p, r in losses) if losses else math.inf,
        "keys1_rel": rel(pk[:b], rk[:b]) if pk is not None and pk.shape[0] >= b else math.inf,
        "keys_rel": rel(pk, rk) if pk is not None and pk.shape == rk.shape else math.inf,
        "grad_global_gap": abs(math.hypot(*(prog["grad"][n] for n in grads))
                               - math.hypot(*(ref["grad"][n] for n in grads)))
        / math.hypot(*(ref["grad"][n] for n in grads)) if grads else math.inf,
        "loss1_gap": abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
        "keys1_gap": float((pk[:b].double() - ref["keys"][:b].double()).abs().max())
        if pk is not None and pk.shape[0] >= b else math.inf,
    }


def decide(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (a number without a limit fails)."""
    return all(n in limits and numbers[n][0] <= float(limits[n]) for n in numbers)
