"""The plain verifier: judges a Cairo-M proof, given as the JSON object of
its native framing, at a stated security configuration.

Checks, in the transcript's order (the reference verifier.rs):
- the preprocessed commitment equals the one recomputed here (`commit`);
- the interaction proof of work;
- the LogUp balance: the public data's contribution plus every
  component's claimed sum is zero;
- the composition identity at the out-of-domain point, from the sampled
  masks and the AIR (`components/`);
- the PCS: every Merkle opening against its root, the DEEP quotients at
  the queried pairs, every FRI fold, the last layer's degree and the
  query proof of work.

Raises `Rejected` on the first failed check.  Imports nothing outside
this directory but NumPy and the standard library.
"""

from __future__ import annotations

import hashlib

import numpy as np

from . import commit, domain
from . import field as f
from .air import EvalAtRow, HostArrayOps, Val, logup_shift_scalar
from .channel import Blake2sChannel
from .components.registry import ComponentSet
from .relations import Relations
from .scale import INTERACTION_POW_BITS, REGULAR_96_BITS, TREE_HEIGHT

P = f.P
INV2 = (P + 1) // 2
QZERO = f.QZERO
_BASIS = [(1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1)]


class Rejected(Exception):
    pass


def _check(ok: bool, what: str):
    if not ok:
        raise Rejected(what)


# -- public data --

def _present(entries):
    return [e for e in entries if e is not None]


def mix_public_data(pd: dict, channel):
    channel.mix_u32s([pd["initial_registers"][0], pd["initial_registers"][1],
                      pd["final_registers"][0], pd["final_registers"][1],
                      pd["clock"], pd["initial_root"], pd["final_root"]])
    channel.mix_u32s([len(pd["program"]), len(pd["input"]), len(pd["output"])])
    for key in ("program", "input", "output"):
        flat = []
        for addr, v, clock in _present(pd[key]):
            flat += [addr, v[0], v[1], v[2], v[3], clock]
        channel.mix_u32s(flat)


def initial_logup_sum(pd: dict, rel: Relations):
    """The public data's LogUp terms (public_data.rs): the registers'
    first state emitted and last consumed, both memory roots, the program
    and input emitted and the output consumed, each entry with its four
    Merkle-leaf consumptions."""

    def comb(r, vals):
        acc = QZERO
        for j, v in enumerate(vals):
            acc = f.qadd(acc, f.qmul_m31(r.alpha_powers[j], int(v) % P))
        return f.qsub(acc, r.z)

    ir, fr, clock = pd["initial_registers"], pd["final_registers"], pd["clock"]
    terms = [(1, comb(rel.registers, [ir[0], ir[1], 1])),
             (-1, comb(rel.registers, [fr[0], fr[1], clock + 1])),
             (1, comb(rel.merkle, [0, 0, pd["initial_root"], pd["initial_root"]])),
             (1, comb(rel.merkle, [0, 0, pd["final_root"], pd["final_root"]]))]
    for key, sign, root in (("program", 1, pd["initial_root"]),
                            ("input", 1, pd["initial_root"]),
                            ("output", -1, pd["final_root"])):
        for addr, v, c in _present(pd[key]):
            terms.append((sign, comb(rel.memory, [addr, c, *v])))
            for k in range(4):
                terms.append((-1, comb(rel.merkle, [4 * addr + k, TREE_HEIGHT, v[k], root])))
    total = QZERO
    for sign, d in terms:
        inv = f.qinv(d)
        total = f.qadd(total, inv) if sign > 0 else f.qsub(total, inv)
    return total


# -- the composition at the out-of-domain point --

def _arr1(q):
    return tuple(np.array([x], np.uint32) for x in q)


def composition_at(comps, s_trace, s_inter, s_pre, claimed, coeff, z):
    """sum over components of (their constraints combined by ``coeff``) /
    V(z), each component's block shifted by coeff^(constraints after)."""
    counts, contribs = [], []
    for ci, comp in enumerate(comps):
        def tg(idx, off, _ci=ci):
            return Val(_arr1(s_trace[_ci][idx][0]), True, HostArrayOps)

        def pg(idx, off, _ci=ci):
            return Val(_arr1(s_pre[_ci][idx][0]), True, HostArrayOps)

        def ig(idx, off, _ci=ci):
            acc = QZERO
            for limb in range(4):
                col = s_inter[_ci][4 * idx + limb]
                acc = f.qadd(acc, f.qmul(col[1] if off == 0 else col[0], _BASIS[limb]))
            return Val(_arr1(acc), True, HostArrayOps)

        shift = Val(_arr1(logup_shift_scalar(claimed[ci], comp.log_size)), True, HostArrayOps)
        ev = EvalAtRow(HostArrayOps, tg, ig, shift, pg)
        comp.evaluate(ev)
        acc = None
        for c in ev.constraints:
            ce = tuple(int(np.asarray(x).reshape(-1)[0]) for x in c.as_ext().v)
            acc = ce if acc is None else f.qadd(f.qmul(acc, coeff), ce)
        counts.append(len(ev.constraints))
        contribs.append(f.qmul(acc, f.qinv(domain.vanishing_at(comp.log_size, z))))
    total = QZERO
    for i, c in enumerate(contribs):
        total = f.qadd(total, f.qmul(c, f.qpow(coeff, sum(counts[i + 1:]))))
    return total


# -- Merkle openings --

def verify_opening(root: bytes, log_size: int, dec: dict, positions) -> list:
    """Check one tree's opening at ``positions``; -> per column
    {position: value}."""
    values = [{int(p): int(v) for p, v in col.items()} for col in dec["values"]]
    siblings = iter(bytes.fromhex(h) for h in dec["siblings"])
    k = len(values)
    pad = b"\x00" * 4 * ((1 << max(0, (k - 1).bit_length())) - k)
    digests = {}
    for p in positions:
        _check(all(p in col for col in values), "opening lacks a queried leaf")
        msg = b"".join(col[p].to_bytes(4, "little") for col in values)
        digests[p] = hashlib.blake2s(msg + pad).digest()
    cur = list(positions)
    for _ in range(log_size):
        parents, nxt = [], {}
        for p in cur:
            if p ^ 1 not in digests:
                sib = next(siblings, None)
                _check(sib is not None, "opening lacks a sibling")
                digests[p ^ 1] = sib
            par = p >> 1
            if par not in nxt:
                l, r = (digests[p], digests[p ^ 1]) if p % 2 == 0 else (digests[p ^ 1], digests[p])
                nxt[par] = hashlib.blake2s(l + r).digest()
                parents.append(par)
        digests, cur = nxt, parents
    _check(next(siblings, None) is None, "opening has spare siblings")
    _check(digests.get(0) == root, "Merkle path does not reach the root")
    return values


def pair_positions(queries, max_log: int, l: int):
    return sorted({q for p in queries
                   for q in ((p >> (max_log - l)) & ~1, (p >> (max_log - l)) | 1)})


# -- DEEP quotients and FRI --

def _weighted_sums(entries, positions):
    """sum_i alpha^i * column_i[pos] for every position: QM31 weights times
    M31 values, the values split in 16-bit halves so that uint64 sums of
    up to 2^16 products cannot wrap."""
    w = np.array([ap for _, _, ap in entries], np.uint64)  # (n, 4)
    v = np.array([[col[p] for p in positions] for col, _, _ in entries], np.uint64)
    lo = (w.T @ (v & 0xFFFF)) % P
    hi = (w.T @ (v >> 16)) % P
    s = (lo + hi * (1 << 16)) % P  # (4, n_positions)
    return [tuple(int(x) for x in s[:, j]) for j in range(len(positions))]


def quotients_at(log_size: int, batches, positions):
    """Q_l at commit-order positions: for each sample point z, the columns'
    alpha-weighted (value - line through (z, v) and (conj z, conj v)) over
    the line through z and conj(z)."""
    points = [domain.commit_pos_point(pos, log_size) for pos in positions]
    totals = [QZERO] * len(positions)
    for z, entries in batches:
        zx, zy = z
        c = f.qsub(f.qconj(zy), zy)
        wa = wb = QZERO
        for _, v, apow in entries:
            a = f.qsub(f.qconj(v), v)
            b = f.qsub(f.qmul(v, c), f.qmul(a, zy))
            wa = f.qadd(wa, f.qmul(apow, a))
            wb = f.qadd(wb, f.qmul(apow, b))
        dx = f.qsub(f.qconj(zy), zy)
        dy = f.qsub(zx, f.qconj(zx))
        dc = f.qsub(f.qmul(f.qconj(zx), zy), f.qmul(zx, f.qconj(zy)))
        for j, wf in enumerate(_weighted_sums(entries, positions)):
            px, py = points[j]
            numer = f.qsub(f.qmul(wf, c), f.qadd(f.qmul_m31(wa, py), wb))
            den = f.qadd(f.qadd(f.qmul_m31(dx, px), f.qmul_m31(dy, py)), dc)
            totals[j] = f.qadd(totals[j], f.qmul(numer, f.qinv(den)))
    return dict(zip(positions, totals))


def fold(v0, v1, inv_tw: int, alpha):
    f0 = f.qmul_m31(f.qadd(v0, v1), INV2)
    f1 = f.qmul_m31(f.qmul_m31(f.qsub(v0, v1), inv_tw), INV2)
    return f.qadd(f0, f.qmul(f1, alpha))


def verify_fri(channel, cfg, counts: dict, fri: dict, quotient_values, queries_box):
    """Replay FRI's commitments; after the query draw (``queries_box``
    filled by the caller), check every fold."""
    logs = sorted(counts, reverse=True)
    max_log, last = logs[0], cfg.log_last_layer_size
    alpha0 = channel.draw_felt()
    roots = [bytes.fromhex(r) for r in fri["inner_roots"]]
    _check(len(roots) == max_log - 1 - last, "wrong number of FRI layers")
    alphas = []
    for r in roots:
        channel.mix_root(r)
        alphas.append(channel.draw_felt())
    last_layer = [tuple(int(x) for x in q) for q in fri["last_layer"]]
    _check(len(last_layer) == 1 << last, "wrong last layer size")
    channel.mix_felts(last_layer)

    def check_queries(queries):
        # the last layer's degree: interpolate its line (commit order)
        s = last
        vals = [last_layer[domain.bitrev(i, s)] for i in range(1 << s)]
        for j in range(s):
            half = len(vals) // 2
            out0, out1 = [], []
            for i in range(half):
                a, b = vals[i], vals[i + half]
                tw = domain.fold_twiddle_inv(max_log, max_log - s + j, domain.bitrev(i, s - 1 - j))
                out0.append(f.qmul_m31(f.qadd(a, b), INV2))
                out1.append(f.qmul_m31(f.qmul_m31(f.qsub(a, b), tw), INV2))
            vals = out0 + out1
        bound = cfg.log_last_layer_degree_bound
        _check(all(c == QZERO for i, c in enumerate(vals) if i % (1 << (s - bound))),
               "FRI last layer above its degree bound")
        layers = []
        for idx, (root, dec) in enumerate(zip(roots, fri["inner_decommitments"])):
            log_k = max_log - 1 - idx
            pairs = pair_positions(queries, max_log, log_k)
            cols = verify_opening(root, log_k, dec, pairs)
            _check(len(cols) == 4, "FRI layer is not four limbs")
            layers.append({p: tuple(cols[j][p] for j in range(4)) for p in pairs})

        def alpha_for(l):
            return alpha0 if l == max_log else alphas[max_log - 1 - l]

        def combined(l, pos):
            cols = quotient_values[l]
            wsq = f.qmul(alpha_for(l), alpha_for(l))
            acc = None
            for cv in cols:
                acc = cv[pos] if acc is None else f.qadd(f.qmul(acc, wsq), cv[pos])
            return acc

        for p in queries:
            pr = p & ~1
            cur = fold(combined(max_log, pr), combined(max_log, pr | 1),
                       domain.fold_twiddle_inv(max_log, 0, pr >> 1), alpha0)
            k, li = max_log - 1, 0
            while k > last:
                q = p >> (max_log - k)
                vals = layers[li]
                _check(vals[q] == cur, "FRI fold does not match the next layer")
                cur = fold(vals[q & ~1], vals[q | 1],
                           domain.fold_twiddle_inv(max_log, max_log - k, q >> 1), alphas[li])
                k -= 1
                li += 1
                if counts.get(k + 1) and k + 1 < max_log:
                    qq = (p >> (max_log - k - 1)) & ~1
                    folded = fold(combined(k + 1, qq), combined(k + 1, qq | 1),
                                  domain.fold_twiddle_inv(k + 1, 0, qq >> 1), alphas[li - 1])
                    asq = f.qmul(alphas[li - 1], alphas[li - 1])
                    cur = f.qadd(f.qmul(cur, asq), folded)
            _check(last_layer[p >> (max_log - last)] == cur, "FRI does not end in the last layer")

    return check_queries


def verify_pcs(channel, cfg, phase_logs, phase_roots, sample_points, pcs: dict):
    sampled = [[[tuple(int(x) for x in v) for v in col] for col in phase]
               for phase in pcs["sampled_values"]]
    _check(len(sampled) == len(phase_logs), "wrong number of sampled phases")
    channel.mix_felts([v for phase in sampled for col in phase for v in col])
    random_coeff = channel.draw_felt()
    samples, apow = [], f.QONE  # (commit log, (phase, column), z, value, alpha^i)
    for pi, (logs, pts, vals) in enumerate(zip(phase_logs, sample_points, sampled)):
        _check(len(pts) == len(logs) == len(vals), "sampled columns do not match")
        for ci, (cl, zs, vs) in enumerate(zip(logs, pts, vals)):
            _check(len(zs) == len(vs), "sampled points do not match")
            for z, v in zip(zs, vs):
                samples.append((cl, (pi, ci), z, v, apow))
                apow = f.qmul(apow, random_coeff)
    grouped: dict = {}  # commit log -> [(z, [(handle, value, alpha^i)])]
    for cl, handle, z, v, ap in samples:
        batches = grouped.setdefault(cl, [])
        for bz, entries in batches:
            if bz == z:
                entries.append((handle, v, ap))
                break
        else:
            batches.append((z, [(handle, v, ap)]))
    counts = {}
    for cl, _, _, _, _ in samples:
        counts[cl] = 1
    # one FRI input column per log size, as the prover's quotients
    quotient_values: dict = {}
    check_queries = verify_fri(channel, cfg, counts, pcs["fri_proof"], quotient_values, None)
    _check(channel.verify_pow(pcs["pow_nonce"], cfg.pow_bits), "query proof of work")
    channel.mix_u64(pcs["pow_nonce"])
    max_log = max(grouped)
    _check(cfg.n_queries <= 1 << max_log, "more queries than the domain")
    queries = channel.draw_queries(cfg.n_queries, max_log)
    opened = {}
    for pi, (logs, roots, decs) in enumerate(zip(phase_logs, phase_roots, pcs["decommitments"])):
        roots_d = dict(roots)
        for cl in sorted(set(logs), reverse=True):
            cols_here = [i for i, l in enumerate(logs) if l == cl]
            dec = decs.get(str(cl))
            _check(dec is not None, "a tree is not opened")
            values = verify_opening(roots_d[cl], cl, dec, pair_positions(queries, max_log, cl))
            _check(len(values) == len(cols_here), "opening has the wrong column count")
            for j, ci in enumerate(cols_here):
                opened[(pi, ci)] = values[j]
    for cl, batches in grouped.items():
        resolved = [(z, [(opened[h], v, ap) for h, v, ap in entries]) for z, entries in batches]
        quotient_values[cl] = [quotients_at(cl, resolved, pair_positions(queries, max_log, cl))]
    check_queries(queries)


# -- the whole proof --

def verify(proof: dict, cfg=REGULAR_96_BITS):
    """Judge ``proof`` (the native framing's JSON object) at ``cfg``;
    raises `Rejected`, returns None when every check holds."""
    channel = Blake2sChannel()
    cfg.mix_into(channel)
    pd = proof["public_data"]
    mix_public_data(pd, channel)
    rel = Relations()
    comps = ComponentSet(rel).all
    log_sizes = [int(l) for l in proof["log_sizes"]]
    _check(len(log_sizes) == len(comps), "wrong number of components")
    for comp, l in zip(comps, log_sizes):
        if comp.n_preprocessed_cols:
            _check(comp.log_size == l, f"{comp.name}: fixed size differs")
        comp.log_size = l
    pcs = proof["pcs_proof"]
    roots = [[(int(l), bytes.fromhex(r)) for l, r in phase] for phase in pcs["phase_roots"]]
    _check(len(roots) == 4, "wrong number of committed phases")
    blow = cfg.log_blowup
    phase_logs = []

    def commit_phase(i, trace_logs):
        commit_logs = [l + blow for l in trace_logs]
        _check([l for l, _ in roots[i]] == sorted(set(commit_logs), reverse=True),
               "phase roots do not match the column sizes")
        for _, r in roots[i]:
            channel.mix_root(r)
        phase_logs.append(commit_logs)

    pre_comps = [c for c in comps if c.n_preprocessed_cols]
    pre_cols = [(c.log_size, col) for c in pre_comps for col in c.preprocessed_columns()]
    _check(roots[0] == commit.commit_roots(pre_cols, blow), "preprocessed commitment")
    commit_phase(0, [l for l, _ in pre_cols])
    for comp in comps:
        channel.mix_u64(comp.log_size)
    commit_phase(1, [c.log_size for c in comps for _ in range(c.n_trace_cols)])
    nonce = int(proof["interaction_pow_nonce"])
    _check(channel.verify_pow(nonce, INTERACTION_POW_BITS), "interaction proof of work")
    channel.mix_u64(nonce)
    rel.draw(channel)
    claimed = [tuple(int(x) for x in c) for c in proof["claimed_sums"]]
    _check(len(claimed) == len(comps), "wrong number of claimed sums")
    total = initial_logup_sum(pd, rel)
    for c in claimed:
        total = f.qadd(total, c)
    _check(total == QZERO, "LogUp sum does not balance")
    channel.mix_felts(claimed)
    commit_phase(2, [c.log_size for c in comps for _ in range(4 * c.n_interaction_cols())])
    coeff = channel.draw_felt()
    comp_log = max(c.log_size for c in comps) + blow
    commit_phase(3, [comp_log] * 4)

    # the out-of-domain point, from t on the projective line
    t = channel.draw_felt()
    t2 = f.qmul(t, t)
    dinv = f.qinv(f.qadd(f.QONE, t2))
    z = (f.qmul(f.qsub(f.QONE, t2), dinv), f.qmul(f.qadd(t, t), dinv))
    pre_points = [[z]] * len(pre_cols)
    trace_points = [[z] for c in comps for _ in range(c.n_trace_cols)]
    inter_points = [[domain.step_back(z, c.log_size), z]
                    for c in comps for _ in range(4 * c.n_interaction_cols())]
    sample_points = [pre_points, trace_points, inter_points, [[z]] * 4]

    sampled = [[[tuple(int(x) for x in v) for v in col] for col in phase]
               for phase in pcs["sampled_values"]]
    _check(len(sampled) == 4 and all(len(s) == len(p) for s, p in zip(sampled, sample_points)),
           "sampled values do not match the columns")
    s_trace, s_inter, s_pre = [], [], []
    ti = ii = pi = 0
    for comp in comps:
        s_trace.append(sampled[1][ti: ti + comp.n_trace_cols])
        ti += comp.n_trace_cols
        n = 4 * comp.n_interaction_cols()
        s_inter.append(sampled[2][ii: ii + n])
        ii += n
        s_pre.append(sampled[0][pi: pi + comp.n_preprocessed_cols])
        pi += comp.n_preprocessed_cols
    expected = composition_at(comps, s_trace, s_inter, s_pre, claimed, coeff, z)
    at_z = QZERO
    for k in range(4):
        at_z = f.qadd(at_z, f.qmul(sampled[3][k][0], _BASIS[k]))
    _check(at_z == expected, "composition does not match the AIR at the OODS point")
    verify_pcs(channel, cfg, phase_logs, roots, sample_points, pcs)
