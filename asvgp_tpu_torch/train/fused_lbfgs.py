"""Single-evaluation-site L-BFGS with a zoom line search.

PyTorch counterpart of ``asvgp_tpu/train/fused_lbfgs.py``: optax.lbfgs
with optax.scale_by_zoom_linesearch (strong-Wolfe zoom, Algorithms 3.5/3.6
of Nocedal & Wright 1999, with the Hager-Zhang approximate-decrease
relaxation), rotated so that each step of the loop evaluates value and
gradient at exactly one query point q = x + t·d and a scalar controller
then decides the next query: enlarge the bracket, zoom into the interval,
or accept the step and compute a new L-BFGS direction.  The evaluation
count is the loop's trip count.

The controller, the parameter vector and the L-BFGS memory (the (mem, n)
pairs S, Y and ρ) live on the host in float64 numpy: the hyperparameters
are a handful of scalars, so each decision is a few flops, and the only
device traffic is the objective's own evaluation (see ``fit_lbfgs``).  The
branches and their order of operations are the JAX engine's, so the two
take the same decisions on the same values.
"""

from __future__ import annotations

import numpy as np

_F = np.float64

# optax's zoom line-search constants, as the JAX engine's defaults: the
# Armijo slope c1, the Hager-Zhang approximate-decrease tolerance, the
# bracket growth and the smallest interval
SLOPE_RTOL = 1e-4
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
INTERVAL_THRESHOLD = 1e-5


def make_fused_run(value_and_grad, *, max_iters: int, tol: float,
                   memory_size: int, max_linesearch_steps: int = 30,
                   curv_rtol: float = 0.9, ls_guess: str = "keep"):
    """Build ``run(x0) -> (x, iters, value, grad_norm, evals)`` over float64
    vectors, with ``value_and_grad(q) -> (float, ndarray)`` the single
    evaluation site."""
    if ls_guess not in ("keep", "one"):
        raise ValueError(f"ls_guess must be 'keep' or 'one', got {ls_guess!r}")
    mem = memory_size
    inf = _F(np.inf)
    zero = _F(0.0)
    one = _F(1.0)

    def dot(a, b):
        return _F(np.dot(a, b))

    def _dec_err(t, f_t, s_t, f0, s0):
        # sufficient decrease (3.7a) with the Hager-Zhang approximate
        # decrease alternative (eq. 23), exactly as optax
        armijo = f_t - f0 - SLOPE_RTOL * t * s0
        approx = np.maximum(
            s_t - (2.0 * SLOPE_RTOL - 1.0) * s0,
            f_t - f0 - APPROX_DEC_RTOL * np.abs(f0),
        )
        err = np.maximum(np.minimum(armijo, approx), 0.0)
        return inf if np.isnan(err) else _F(err)

    def _curv_err(s_t, s0):
        # strong-Wolfe curvature (3.7b)
        err = np.maximum(np.abs(s_t) - curv_rtol * np.abs(s0), 0.0)
        return inf if np.isnan(err) else _F(err)

    def _cubicmin(a, fa, fpa, b, fb, c, fc):
        C = fpa
        db, dc = b - a, c - a
        denom = (db * dc) ** 2 * (db - dc)
        d1 = np.array([[dc ** 2, -(db ** 2)], [-(dc ** 3), db ** 3]], dtype=_F)
        AB = d1 @ np.array([fb - fa - C * db, fc - fa - C * dc], dtype=_F) / denom
        A, B = AB[0], AB[1]
        radical = B * B - 3.0 * A * C
        return a + (-B + np.sqrt(radical)) / (3.0 * A)

    def _quadmin(a, fa, fpa, b, fb):
        D, C = fa, fpa
        db = b - a
        B = (fb - D - C * db) / (db ** 2)
        return a - C / (2.0 * B)

    def _middle(low, f_low, s_low, high, f_high, cref, f_cref):
        """Next zoom trial point from the current interval: cubic if well
        inside, else quadratic, else bisection."""
        delta = np.abs(high - low)
        left = np.minimum(high, low)
        right = np.maximum(high, low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        mc = _cubicmin(low, f_low, s_low, high, f_high, cref, f_cref)
        use_cubic = (mc > left + cubic_chk) and (mc < right - cubic_chk)
        mq = _quadmin(low, f_low, s_low, high, f_high)
        use_quad = (not use_cubic) and (mq > left + quad_chk) and (mq < right - quad_chk)
        if use_cubic:
            middle = mc
        elif use_quad:
            middle = mq
        else:
            middle = (low + high) / 2.0
        return _F(middle), bool(delta <= INTERVAL_THRESHOLD)

    def _direction(c, S, Y, rho, g, gamma):
        """Two-loop recursion (Nocedal & Wright alg. 7.4) in optax's index
        order: slots visited oldest to newest, (c % mem + i) % mem."""
        idx = [(c % mem + i) % mem for i in range(mem)]
        r = g.copy()
        alphas = [zero] * mem
        for pos in range(mem - 1, -1, -1):
            i = idx[pos]
            alphas[pos] = rho[i] * dot(S[i], r)
            r = r - alphas[pos] * Y[i]
        r = gamma * r
        for pos in range(mem):
            i = idx[pos]
            beta = rho[i] * dot(Y[i], r)
            r = r + (alphas[pos] - beta) * S[i]
        return -r

    def run(x0):
        x = np.array(x0, dtype=_F)
        n = x.shape[0]
        st = dict(
            x=x, f_x=inf, g_x=np.zeros(n), d=np.zeros(n), slope0=zero,
            t=zero, ls_iter=0, guess=one, interval_found=False,
            prev_t=zero, prev_f=inf, prev_s=zero,
            low=zero, f_low=inf, s_low=zero,
            high=zero, f_high=inf, s_high=zero,
            cref=zero, f_cref=inf,
            safe_t=zero, safe_f=inf, safe_g=np.zeros(n),
            too_small=False, first=True,
            S=np.zeros((mem, n)), Y=np.zeros((mem, n)), rho=np.zeros(mem),
            k=0, evals=0, done=False,
        )
        with np.errstate(all="ignore"):
            while not st["done"]:
                st = _body(st)
        gnorm = np.sqrt(dot(st["g_x"], st["g_x"]))
        return st["x"], st["k"], st["f_x"], _F(gnorm), st["evals"]

    def _body(st):
        # ---- the single evaluation site ----
        q = st["x"] + st["t"] * st["d"]
        f_t, g_t = value_and_grad(q)
        f_t = _F(f_t)
        g_t = np.asarray(g_t, dtype=_F)
        evals = st["evals"] + 1
        s_t = dot(g_t, st["d"])
        t = st["t"]

        f0, s0 = st["f_x"], st["slope0"]
        dec_err = _dec_err(t, f_t, s_t, f0, s0)
        curv_err = _curv_err(s_t, s0)
        err = np.maximum(dec_err, curv_err)
        done_ls = bool(err <= 0.0)
        in_zoom = st["interval_found"]

        # safe-step bookkeeping: any point with sufficient decrease, in the
        # zoom phase only if it improves on the stored one
        safe_upd = (dec_err <= 0.0) and (f_t < st["safe_f"] if in_zoom else True)
        safe_t = t if safe_upd else st["safe_t"]
        safe_f = f_t if safe_upd else st["safe_f"]
        safe_g = g_t if safe_upd else st["safe_g"]

        failed = (not done_ls) and (
            (st["ls_iter"] + 1 >= max_linesearch_steps)
            or (in_zoom and st["too_small"] and safe_t > 0.0)
        )
        accept = st["first"] or done_ls or failed

        if accept:
            # ---- accept: take the step, update memory, new direction
            outside = bool(np.isinf(dec_err))
            use_safe = failed and (safe_t > 0.0 or outside)
            if st["first"]:
                step_t, f_new, g_new = zero, f_t, g_t
            elif use_safe:
                step_t, f_new, g_new = safe_t, safe_f, safe_g
            else:
                step_t, f_new, g_new = t, f_t, g_t
            x_new = st["x"] + step_t * st["d"]

            c = 0 if st["first"] else st["k"] + 1
            dx = x_new - st["x"]
            dg = g_new - st["g_x"]
            # the first update stores zeros (no previous point), like optax
            if c == 0:
                dx = np.zeros_like(dx)
                dg = np.zeros_like(dg)
            vdd = dot(dg, dx)
            w = zero if vdd == 0.0 else one / vdd
            slot = (c - 1) % mem
            S2, Y2, rho2 = st["S"].copy(), st["Y"].copy(), st["rho"].copy()
            S2[slot], Y2[slot], rho2[slot] = dx, dg, w
            denom = dot(dg, dg)
            gamma = vdd / denom if denom > 0.0 else one
            gnorm_new = np.sqrt(dot(g_new, g_new))
            if c == 0:
                gamma = np.minimum(one, one / gnorm_new)
            d_new = _direction(c, S2, Y2, rho2, g_new, gamma)
            slope0_new = dot(d_new, g_new)
            if ls_guess == "keep":
                guess_new = st["guess"] if st["first"] else _F(step_t)
            else:
                guess_new = one
            done_outer = not ((c == 0) or ((c < max_iters) and (gnorm_new >= tol)))
            return dict(
                x=x_new, f_x=f_new, g_x=g_new, d=d_new, slope0=slope0_new,
                t=guess_new, ls_iter=0, guess=guess_new, interval_found=False,
                prev_t=zero, prev_f=f_new, prev_s=slope0_new,
                low=zero, f_low=f_new, s_low=slope0_new,
                high=zero, f_high=f_new, s_high=slope0_new,
                cref=zero, f_cref=f_new,
                safe_t=zero, safe_f=f_new, safe_g=g_new,
                too_small=False, first=False,
                S=S2, Y=Y2, rho=rho2, k=c, evals=evals, done=done_outer,
            )

        # ---- continue the line search: bracket or zoom bookkeeping and the
        # next trial point
        if in_zoom:
            # zoom (optax _zoom_into_interval, rotated): t was the middle
            z_set_high_mid = (dec_err > 0.0) or (f_t >= st["f_low"])
            secant = s_t * (st["high"] - st["low"])
            z_set_high_low = (secant >= 0.0) and not z_set_high_mid
            if z_set_high_mid:
                n_high, n_f_high, n_s_high = t, f_t, s_t
                n_low, n_f_low, n_s_low = st["low"], st["f_low"], st["s_low"]
            elif z_set_high_low:
                n_high, n_f_high, n_s_high = st["low"], st["f_low"], st["s_low"]
                n_low, n_f_low, n_s_low = t, f_t, s_t
            else:
                n_high, n_f_high, n_s_high = st["high"], st["f_high"], st["s_high"]
                n_low, n_f_low, n_s_low = t, f_t, s_t
            if z_set_high_mid or z_set_high_low:
                n_cref, n_f_cref = st["high"], st["f_high"]
            else:
                n_cref, n_f_cref = st["low"], st["f_low"]
            n_found = True
        else:
            # bracketing (optax _search_interval, rotated)
            set_high_new = (dec_err > 0.0) or ((f_t >= st["prev_f"]) and st["ls_iter"] > 0)
            set_low_new = (s_t >= 0.0) and not set_high_new
            n_found = set_high_new or set_low_new
            if set_low_new:
                n_low, n_f_low, n_s_low = t, f_t, s_t
                n_high, n_f_high, n_s_high = st["prev_t"], st["prev_f"], st["prev_s"]
            else:
                n_low, n_f_low, n_s_low = st["prev_t"], st["prev_f"], st["prev_s"]
                n_high, n_f_high, n_s_high = t, f_t, s_t
            n_cref, n_f_cref = n_low, n_f_low

        mid, too_small = _middle(n_low, n_f_low, n_s_low, n_high, n_f_high, n_cref, n_f_cref)
        # next trial: the zoom middle once an interval exists, else keep
        # enlarging the bracket
        t_cont = mid if n_found else _F(INCREASE_FACTOR * t)
        return dict(
            st, t=t_cont, ls_iter=st["ls_iter"] + 1, interval_found=n_found,
            prev_t=t, prev_f=f_t, prev_s=s_t,
            low=n_low, f_low=n_f_low, s_low=n_s_low,
            high=n_high, f_high=n_f_high, s_high=n_s_high,
            cref=n_cref, f_cref=n_f_cref,
            safe_t=safe_t, safe_f=safe_f, safe_g=safe_g,
            too_small=too_small, first=False, evals=evals,
        )

    return run
