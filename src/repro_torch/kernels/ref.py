"""Plain PyTorch versions of the port's kernels: the oracles.

Each function is the direct definition, materializing whatever
intermediates it likes, as ``repro/kernels/ref.py`` does for the Pallas
kernels. On the CPU the dispatch in ``ops.py`` runs these; on the card
``chip_smoke.py`` holds each hand-written kernel against them.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def nstep_returns_ref(rewards, dones, bootstrap, gamma: float):
    """Paper Algorithm 1 lines 11-15, time-major: rewards/dones (T, E),
    bootstrap (E,) -> returns (T, E) float32, with
    R_t = r_t + gamma * (1 - done_t) * R_{t+1} from R_T = bootstrap."""
    nd = 1.0 - dones.float()
    carry = bootstrap.float()
    out = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        carry = rewards[t].float() + (gamma * nd[t]) * carry
        out.append(carry)
    return torch.stack(out[::-1])


def vtrace_returns_ref(rewards, dones, values, bootstrap, rho, gamma: float,
                       rho_bar: float = 1.0, c_bar: float = 1.0):
    """V-trace (Espeholt et al. 2018) by the definition, time-major:
    rewards/dones/values/rho (T, E), bootstrap (E,) -> ``(vs, pg_adv)``,
    each (T, E) float32. With rc = min(rho, rho_bar), c = min(rho, c_bar)
    and nd = 1 - done:

        delta_t = rc_t (r_t + gamma nd_t V_{t+1} - V_t)
        A_t = delta_t + gamma nd_t c_t A_{t+1}        A_T = 0
        vs_t = V_t + A_t
        pg_adv_t = rc_t (r_t + gamma nd_t vs_{t+1} - V_t)

    with V_T = vs_T = bootstrap."""
    r = rewards.float()
    nd = 1.0 - dones.float()
    v = values.float()
    b = bootstrap.float()
    rc = torch.clamp(rho.float(), max=rho_bar)
    c = torch.clamp(rho.float(), max=c_bar)
    v_next = torch.cat([v[1:], b[None]])
    delta = rc * (r + gamma * nd * v_next - v)
    acc = torch.zeros_like(b)
    out = []
    for t in range(r.shape[0] - 1, -1, -1):
        acc = delta[t] + gamma * nd[t] * c[t] * acc
        out.append(v[t] + acc)
    vs = torch.stack(out[::-1])
    vs_next = torch.cat([vs[1:], b[None]])
    pg_adv = rc * (r + gamma * nd * vs_next - v)
    return vs, pg_adv


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None,
                        return_lse=False):
    """q: (B, Sq, H, D); k: (B, Sk, Hkv, D); v: (B, Sk, Hkv, Dv). Returns
    (B, Sq, H, Dv); with ``return_lse`` also each row's log-sum-exp
    m + log(max(l, 1e-30)) of the scaled, masked scores, (B, Sq, H) fp32,
    what the reference's ``_flash_fwd`` returns (a row that sees no key
    gets m = -1e30)."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()) * scale
    s = s.masked_fill(~attention_mask(Sq, Sk, causal, window, q.device)
                      [None, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    o = o.reshape(B, Sq, H, Dv).to(q.dtype)
    if not return_lse:
        return o
    m = s.amax(dim=-1)
    lse = m + torch.log(torch.clamp(torch.exp(s - m[..., None]).sum(-1),
                                    min=1e-30))
    return o, lse.reshape(B, Sq, H)


def attention_mask(Sq: int, Sk: int, causal: bool, window: int, device,
                   k0: int = 0, k1=None):
    """(Sq, k1 - k0) bool: which of keys k0..k1 - 1 (default all Sk) each
    query sees, causal (key <= query) and within ``window`` when it is > 0
    (key > query - window)."""
    k1 = Sk if k1 is None else k1
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(k0, k1, device=device)[None, :]
    mask = k_pos < Sk
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & (k_pos > q_pos - window)
    return mask


def flash_attention_bwd(q, k, v, out, lse, d_out, *, causal=True, window=0,
                        scale=None, block_k: int = 512):
    """The gradient of ``flash_attention_ref`` given its output and LSE: the
    port of the reference's ``_flash_attention_xla_bwd``
    (``repro/models/attention.py:109-146``), which is plain XLA outside any
    Pallas kernel. delta = sum(dO * O) a row; then for each block of
    ``block_k`` keys P = exp(S - lse) is recomputed from (q, k, lse), and
    dV += P^T dO, dP = dO V^T, dS = P (dP - delta), dQ += dS K and
    dK = dS^T q. The operands are rounded to q's dtype and the products
    summed in fp32, as the reference's ``preferred_element_type`` does; q
    is scaled before the products, as the reference pre-scales it. GQA
    sums dK and dV over each KV head's query group. Returns (dq, dk, dv)
    in the dtypes of q, k and v."""
    B, Sq, H, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    G = H // Hkv
    dtype = q.dtype
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qs = (q * scale).reshape(B, Sq, Hkv, G, D).float()
    do = d_out.to(dtype).reshape(B, Sq, Hkv, G, Dv).float()
    lse = lse.reshape(B, Sq, Hkv, G)
    delta = (d_out.float() * out.float()).sum(-1).reshape(B, Sq, Hkv, G)
    dq = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for k0 in range(0, Sk, block_k):
        k1 = min(k0 + block_k, Sk)
        kb, vb = k[:, k0:k1].float(), v[:, k0:k1].float()
        s = torch.einsum("bqhgd,bkhd->bqhgk", qs, kb)
        mask = attention_mask(Sq, Sk, causal, window, q.device, k0, k1)
        s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
        p = torch.exp(s - lse[..., None])
        dvs.append(torch.einsum("bqhgk,bqhgd->bkhd", p.to(dtype).float(), do)
                   .to(v.dtype))
        dp = torch.einsum("bqhgd,bkhd->bqhgk", do, vb)
        ds = (p * (dp - delta[..., None])).to(dtype).float()
        dq = dq + torch.einsum("bqhgk,bkhd->bqhgd", ds, kb)
        dks.append(torch.einsum("bqhgk,bqhgd->bkhd", ds, qs).to(k.dtype))
    # dq is the gradient of the pre-scaled q; the scaling's own chain rule
    dq = dq.to(dtype) * scale
    return (dq.reshape(B, Sq, H, D), torch.cat(dks, dim=1),
            torch.cat(dvs, dim=1))


def live_slots(pos, S: int, window: int, device):
    """The cache slots a decode step at ``pos`` attends to, as a bool mask:
    (1, S) for an int ``pos``, (B, S) for a (B,) integer tensor.

    With ``window == 0``, slots 0..pos (all S once pos >= S: the ring
    cache; none for a negative pos). Otherwise the ring's age rule of
    ``repro/models/attention.py``: slot j holds the token of age
    (pos mod S - j) mod S and is live iff that age < min(window, pos + 1).
    """
    slots = torch.arange(S, device=device)
    if isinstance(pos, torch.Tensor):
        p = pos.to(device=device, dtype=torch.long)[:, None]  # (B, 1)
    else:
        p = torch.full((1, 1), int(pos), dtype=torch.long, device=device)
    if not window:
        return slots[None, :] <= p
    age = torch.remainder(torch.remainder(p, S) - slots[None, :], S)
    return age < torch.clamp(p + 1, max=window)


def decode_attention_ref(q, k_cache, v_cache, pos, *, scale=None,
                         window: int = 0):
    """q: (B, H, D); k_cache: (B, S, Hkv, D); v_cache: (B, S, Hkv, Dv).
    ``pos`` is an int (every row attends to slots <= pos) or a (B,) integer
    tensor (row b attends to slots <= pos[b]); a ``window`` > 0 keeps only
    the slots ``live_slots`` gives. Returns (B, H, Dv)."""
    B, H, D = q.shape
    _, S, Hkv, Dv = v_cache.shape
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
    valid = live_slots(pos, S, window, q.device)  # (B or 1, S)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, H, Dv).to(q.dtype)


def mla_decode_attention_ref(q_lat, q_rope, c_cache, kr_cache, pos, scale,
                             window: int = 0):
    """Latent-space (absorbed) MLA decode. q_lat (B, H, R), q_rope (B, H, Rr),
    c_cache (B, S, R), kr_cache (B, S, Rr); ``pos`` an int or a (B,) integer
    tensor and ``window`` as in ``decode_attention_ref``. Returns (B, H, R)
    in q_lat's dtype:

        s_k = (q_lat . c_k + q_rope . kr_k) * scale    for live k
        out = sum_k softmax(s)_k c_k
    """
    c = c_cache.float()
    s = torch.einsum("bhr,bkr->bhk", q_lat.float(), c)
    s = s + torch.einsum("bhr,bkr->bhk", q_rope.float(), kr_cache.float())
    s = s * scale
    valid = live_slots(pos, c_cache.shape[1], window, q_lat.device)
    s = s.masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkr->bhr", p, c).to(q_lat.dtype)


def ssd_scan_ref(x, dt, A_log, B_mat, C_mat, D_vec, *, chunk: int):
    """Chunked SSD (Mamba2) scan, fp32 inside: the algorithm of
    ``repro/models/ssm.py::ssd_chunked``. x (B, S, H, P); dt (B, S, H)
    post-softplus; A_log, D_vec (H,); B_mat, C_mat (B, S, N), shared across
    heads. Returns ``(y, final_state)``: y (B, S, H, P) in x's dtype, the
    state (B, H, P, N) float32. Per chunk of Q steps, with cum the inclusive
    cumsum of a = -exp(A_log) dt inside the chunk:

        y_i = sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j
              + exp(cum_i) C_i . state + D x_i
        state <- exp(cum_Q) state + sum_j exp(cum_Q - cum_j) (dt_j x_j) B_j^T

    The decay mask is applied before ``exp``: above the diagonal cum_i -
    cum_j is a positive sum that passes 88 within a chunk once exp(A_log)
    dt is large (F21), and exp of it is inf. The forward drops those
    entries either way; masking them to -inf first keeps autograd's 0 *
    inf out of the gradients of dt and A_log (``ssd_scan_bwd``).
    """
    return _ssd_chunked(x, dt, A_log, B_mat, C_mat, D_vec, chunk,
                        torch.float32)


def _ssd_chunked(x, dt, A_log, B_mat, C_mat, D_vec, chunk: int, exponents):
    """``ssd_scan_ref`` with a, cum and the differences of cum taken in the
    ``exponents`` dtype; each exp and every product is fp32."""
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_scan: seq {S} % chunk {chunk} != 0")
    nc = S // chunk
    xf = x.float()
    dtf = dt.float()
    a = -torch.exp(A_log.to(exponents))[None, None, :] * dt.to(exponents)
    xc = xf.reshape(Bsz, nc, chunk, H, P)
    dtc = dtf.reshape(Bsz, nc, chunk, H)
    Bc = B_mat.float().reshape(Bsz, nc, chunk, N)
    Cc = C_mat.float().reshape(Bsz, nc, chunk, N)
    cum = torch.cumsum(a.reshape(Bsz, nc, chunk, H), dim=2)  # inclusive
    total = cum[:, :, -1, :]  # (B, nc, H)

    def exp(z):
        return torch.exp(z.float())

    scores = torch.einsum("bcis,bcjs->bcij", Cc, Bc)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q, Q, H)
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))
    L = exp(dec.masked_fill(~tril[None, None, :, :, None], -math.inf))
    xdt = xc * dtc[..., None]  # (B, nc, Q, H, P)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * L, xdt)

    w_state = exp(total[:, :, None, :] - cum)  # (B, nc, Q, H)
    s_chunk = torch.einsum("bcjh,bcjs,bcjhp->bchps", w_state, Bc, xdt)
    state = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    s_in = []
    for c in range(nc):  # the inter-chunk carry
        s_in.append(state)
        state = state * exp(total[:, c])[:, :, None, None] + s_chunk[:, c]
    s_in = torch.stack(s_in, dim=1)  # (B, nc, H, P, N)
    y_inter = torch.einsum("bcih,bcis,bchps->bcihp", exp(cum), Cc, s_in)

    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    y = y + D_vec.float()[None, None, :, None] * xf
    return y.to(x.dtype), state


def ssd_scan_bwd(x, dt, A_log, B_mat, C_mat, D_vec, d_y, d_state, *,
                 chunk: int):
    """The gradient of ``ssd_scan_ref`` with respect to its six inputs,
    given the cotangents ``d_y`` of y and ``d_state`` of the final state
    (either may be None): autograd through the chunked scan recomputed from
    the detached inputs, as the reference differentiates ``ssd_chunked``
    with XLA's autodiff (F4: the TPU kernel has no backward). The masked
    decay keeps it finite where ``ssd_chunked``'s gradient is NaN (F21).

    The recompute takes a, cum and cum_i - cum_j in float64 and the rest
    in fp32. A chunk's cumulative decay reaches -200 at mamba2-370m's
    widest heads (F21's regime), where fp32's spacing is 1.5e-5, so an fp32
    cum_i - cum_j near 0 carries that error into exp and the sums over it:
    1.1e-5 of dA_log's largest value against the exact recurrence, 5e-7
    with the exponents in float64 (``tests/test_torch_ssd_grad.py`` holds
    it to 1e-5 there).
    Returns (dx, d_dt, dA_log, dB, dC, dD), each in its input's dtype."""
    inputs = [t.detach().requires_grad_(True)
              for t in (x, dt, A_log, B_mat, C_mat, D_vec)]
    with torch.enable_grad():
        y, state = _ssd_chunked(*inputs, chunk, torch.float64)
        outs = [(o, g.to(o.dtype)) for o, g in ((y, d_y), (state, d_state))
                if g is not None]
        grads = torch.autograd.grad([o for o, _ in outs],
                                    inputs, [g for _, g in outs],
                                    allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for t, g in zip(inputs, grads))
