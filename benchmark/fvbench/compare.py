"""The numbers that decide ``correct``, each held to a limit of its own
from the cell's limits file (``limits/<workload>.json``), which names the
numbers a cell compares; every other reading rides along for the record.
A cell compares the numbers on which a sound change of summation order
(``reference.F32Sums`` in the program's place) reads well under the fp8
control or a planted fault: with seeded weights some of the others read as
far off for the one as for the other.

Inference: every detection the window produced for the checked pool
batches against the reference's detections of the same batch. Per scan the
reference's detections are taken in score order, and each is paired with
the nearest unpaired detection of the program with the same label, if its
BEV centre lies within ``PAIR_M``:

* ``score_gap_p90``: the 90th percentile of a pair's score difference;
* ``box_gap_med``: the median of a pair's widest difference of its seven
  box values (centre and size in m, heading in rad);
* ``unpaired_share``: the detections of either side left without a
  partner, over all detections of both sides;
* ``unpaired_scans``: the share of scans in which one side detects and no
  detection pairs, an exact comparison (a scan left out, or answered with
  nothing, where the other side detects);
* for the record: the widest gaps.

Quantiles, not the widest gaps: with seeded weights a few detections sit at
the NMS's and the score threshold's knife edges, where a difference in the
order of a sum (an atomic add, another kernel) can swap them; a swapped
detection pairs with a neighbour, or with none.

Training: the program's first steps, taken in set-up through the window's
own call, against the reference's steps from the same state on the same
batches:

* ``steady_loss_gap``: the first step's widest relative difference over the
  limits file's ``steady_terms``, the loss terms that a change of summation
  order leaves steady (FV2P's point segmentation, MGAF-3DSSD's voxel
  segmentation: both read the trunk's features, not the heads' boxes);
* ``grad_gap_med``: the median leaf's gap between the norms of the first
  gradient (from the optimizer's state), over the larger of that leaf's
  reference norm and the median leaf's;
* ``grad_gap_worst``: the same gap of the worst leaf (its name rides along
  as ``grad_gap_worst_leaf``);
* ``change_gap_med``: the median leaf's gap for the parameters' change
  after the steps, over the leaves whose reference gradient is above a
  thousandth of the median leaf's (a gradient that is nought but for
  rounding, as a conv bias under a train-mode BatchNorm, moves its leaf by
  round-off alone);
* for the record: the worst leaf's change gap with its name, its reference
  gradient's norm, the median leaf's, and the share of its elements whose
  gradient is under a thousandth of its largest; each step's total loss.

The worst leaves are on the record only: a change of summation order moves
the first BatchNorms' gradients by 0.2-1.6 of their norm, as fp8 does, and
the change of leaves whose gradient is a fiftieth to a five-hundredth of
the median leaf's (Adam steps them by about the learning rate whatever
that gradient's size) by 0.1-0.2.
"""
import numpy as np

PAIR_M = 1.0
NOISE_LEAF = 1e-3


def _pairs(prog, ref):
    """(pairs [(i_prog, i_ref)], n_prog, n_ref) of one scan's valid rows."""
    pv = np.flatnonzero(prog['pred_valid'])
    rv = np.flatnonzero(ref['pred_valid'])
    order = rv[np.argsort(-ref['pred_scores'][rv], kind='stable')]
    free = set(pv.tolist())
    pairs = []
    for r in order:
        cands = [p for p in free if prog['pred_labels'][p] == ref['pred_labels'][r]]
        if not cands:
            continue
        d = [np.hypot(*(prog['pred_boxes'][p, :2] - ref['pred_boxes'][r, :2]))
             for p in cands]
        j = int(np.argmin(d))
        if d[j] <= PAIR_M:
            pairs.append((cands[j], r))
            free.discard(cands[j])
    return pairs, len(pv), len(rv)


def detections(kept, ref_det):
    """kept {pool index: [program detections of each window batch]},
    ref_det {pool index: reference detections}; arrays (B, K, ...)."""
    unpaired = total = n_out = scans = unpaired_scans = 0
    score_gaps, box_gaps = [], []
    for k, outs in kept.items():
        ref = ref_det[k]
        for out in outs:
            n_out += 1
            prog = {key: np.asarray(v) for key, v in out.items()}
            for b in range(ref['pred_valid'].shape[0]):
                p = {key: v[b] for key, v in prog.items()}
                r = {key: v[b] for key, v in ref.items()}
                pairs, n_p, n_r = _pairs(p, r)
                unpaired += n_p + n_r - 2 * len(pairs)
                total += n_p + n_r
                scans += 1
                unpaired_scans += bool(n_p + n_r) and not pairs
                for i, j in pairs:
                    score_gaps.append(abs(float(p['pred_scores'][i]) - float(r['pred_scores'][j])))
                    box_gaps.append(float(np.abs(p['pred_boxes'][i, :7].astype(np.float64)
                                                 - r['pred_boxes'][j, :7]).max()))
    # no pair at all (nothing detected on one side) is a failure, not a 0
    med = lambda xs: float(np.median(xs)) if xs else float('inf')  # noqa: E731
    q90 = lambda xs: float(np.quantile(xs, 0.9)) if xs else float('inf')  # noqa: E731
    return {'score_gap_p90': q90(score_gaps), 'box_gap_med': med(box_gaps),
            'unpaired_scans': unpaired_scans / max(scans, 1),
            'score_gap_med': med(score_gaps),
            'unpaired_share': unpaired / max(total, 1),
            'score_gap': max(score_gaps, default=float('inf')),
            'box_gap': max(box_gaps, default=float('inf')),
            'outputs_checked': n_out, 'detections': total}


def _norms(leaves):
    return np.array([float(t.detach().double().norm()) for t in leaves])


def _leaf_gaps(prog, ref, keep=None):
    p, r = _norms(prog), _norms(ref)
    floor = max(float(np.median(r)), 1e-30)
    gaps = np.abs(p - r) / np.maximum(r, floor)
    if keep is not None:
        gaps = np.where(keep, gaps, 0.0)
    return gaps


def _small_share(g):
    """The share of a leaf's elements whose gradient is under a thousandth
    of the leaf's largest: the elements that Adam moves by about the
    learning rate on a sign that rounding can set."""
    a = g.detach().double().abs()
    return float((a < NOISE_LEAF * a.max()).double().mean()) if a.numel() else 0.0


def train(prog, ref, names, steady_terms):
    """prog, ref: (loss terms a step, first gradient a leaf, change a leaf)."""
    p_loss, p_grad, p_change = prog
    r_loss, r_grad, r_change = ref
    floor = 1e-6 * abs(r_loss[0]['loss'])
    steady = {t: abs(p_loss[0][t] - r_loss[0][t]) / max(abs(r_loss[0][t]), floor, 1e-30)
              for t in steady_terms}
    grad_gaps = _leaf_gaps(p_grad, r_grad)
    r_grad_norms = _norms(r_grad)
    moving = r_grad_norms > NOISE_LEAF * np.median(r_grad_norms)
    change_gaps = _leaf_gaps(p_change, r_change, moving)
    worst_change = int(change_gaps.argmax())
    return {'steady_loss_gap': max(steady.values()),
            'change_gap_med': float(np.median(change_gaps[moving])),
            'grad_gap_med': float(np.median(grad_gaps)),
            'grad_gap_worst': float(grad_gaps.max()),
            'grad_gap_worst_leaf': names[int(grad_gaps.argmax())],
            'steady_term_gaps': steady,
            'loss_gaps': [abs(a['loss'] - b['loss']) / max(abs(b['loss']), 1e-30)
                          for a, b in zip(p_loss, r_loss)],
            'change_gap_worst': [float(change_gaps[worst_change]), names[worst_change],
                                 float(r_grad_norms[worst_change]),
                                 float(np.median(r_grad_norms)),
                                 _small_share(r_grad[worst_change])],
            'noise_leaves': int((~moving).sum()),
            'losses': [a['loss'] for a in p_loss],
            'reference_losses': [b['loss'] for b in r_loss]}


def judge(checks, limits):
    """{number: {'value', 'limit', 'ok'}} for every number the cell's limits
    file holds. A number that is not finite fails."""
    out = {}
    for name, limit in limits['limits'].items():
        v = float(checks[name])
        out[name] = {'value': v, 'limit': float(limit),
                     'ok': bool(np.isfinite(v) and v <= limit)}
    return out
