"""Block-banded Gauss-Newton linear algebra for the Direct optimizer, as the
JAX package's direct/banded.py.

The Direct cost Hessian is band-limited: a stage residual touches
(q_{t-1}, q_t, q_{t+1}) only, so H is block-pentadiagonal in nv-blocks
(the reference's nband = 3*nv band storage, direct.h:236-302). Grouping
consecutive nv-blocks in pairs makes it block-tridiagonal in 2nv
superblocks, factorised by a sweep of small dense Cholesky and triangular
solves (`banded_gn_solve`). The optimizer itself takes the square-root
route (`srif_gn_solve`): a sweep of small QR factorisations of the stacked
Jacobian rows, never forming J^T J.

The sweeps are Python loops over the blocks; each step is a few small
tensor operations, so a whole solve runs inside one CUDA graph on the
card. `qr_r` is a Householder QR (the R factor only) in plain tensor
operations, the same on the CPU and the card.
"""

from __future__ import annotations

import torch


def qr_r(a: torch.Tensor) -> torch.Tensor:
  """The upper-triangular R (min(rows, cols), cols) of a = Q R by
  Householder reflections (a row of R may differ from LAPACK's in sign;
  every use here solves the rows it is given, so the sign cancels)."""
  rows, cols = a.shape
  k = min(rows, cols)
  for j in range(k):
    x = a[j:, j]
    norm = torch.sqrt(torch.dot(x, x))
    sign = torch.where(x[0] < 0, -torch.ones_like(norm),
                       torch.ones_like(norm))
    v = torch.cat([x[:1] + sign * norm, x[1:]])
    vv = torch.dot(v, v)
    beta = torch.where(vv > 0, 2.0 / torch.clamp(vv, min=1e-30),
                       torch.zeros_like(vv))
    sub = a[j:]
    sub = sub - (beta * v)[:, None] * (v @ sub)[None, :]
    a = torch.cat([a[:j], sub]) if j else sub
  return torch.triu(a[:k])


def _eye(b, like):
  return torch.eye(b, dtype=like.dtype, device=like.device)


def assemble_superblocks(D1, O1, O2):
  """nv-block pentadiagonal storage -> 2nv-superblock tridiagonal.

  D1 (T, b, b) diagonal blocks H[t, t], O1 (T-1, b, b) H[t, t+1], O2
  (T-2, b, b) H[t, t+2]. Returns (Ds (S, 2b, 2b), Us (S-1, 2b, 2b)),
  S = ceil(T/2); an odd T is padded with an identity diagonal block."""
  t_len, b = D1.shape[0], D1.shape[1]
  zero = torch.zeros((1, b, b), dtype=D1.dtype, device=D1.device)
  if t_len % 2:
    D1 = torch.cat([D1, _eye(b, D1)[None]])
    O1 = torch.cat([O1, zero])
    O2 = torch.cat([O2, zero])
    t_len += 1
  s_len = t_len // 2
  O1p = torch.cat([O1, zero])
  O2p = torch.cat([O2, zero, zero])
  even = 2 * torch.arange(s_len, device=D1.device)
  top = torch.cat([D1[even], O1p[even]], dim=2)
  bot = torch.cat([O1p[even].transpose(1, 2), D1[even + 1]], dim=2)
  Ds = torch.cat([top, bot], dim=1)
  ev = even[:-1]
  zs = torch.zeros((s_len - 1, b, b), dtype=D1.dtype, device=D1.device)
  utop = torch.cat([O2p[ev], zs], dim=2)
  ubot = torch.cat([O1p[ev + 1], O2p[ev + 1]], dim=2)
  return Ds, torch.cat([utop, ubot], dim=1)


def block_tridiag_cholesky(Ds, Us):
  """Blocked Cholesky of an SPD block-tridiagonal matrix: Ds (S, b, b)
  diagonal, Us (S-1, b, b) upper blocks H[s, s+1]. Returns (L (S, b, b)
  lower factors, W (S-1, b, b) = L_s^-1 U_s)."""
  s_len, b = Ds.shape[0], Ds.shape[1]
  w_prev = torch.zeros((b, b), dtype=Ds.dtype, device=Ds.device)
  ls, ws = [], []
  for s in range(s_len):
    l_s = torch.linalg.cholesky_ex(Ds[s] - w_prev.T @ w_prev).L
    ls.append(l_s)
    if s < s_len - 1:
      w_prev = torch.linalg.solve_triangular(l_s, Us[s], upper=False)
      ws.append(w_prev)
  W = torch.stack(ws) if ws else torch.zeros((0, b, b), dtype=Ds.dtype,
                                             device=Ds.device)
  return torch.stack(ls), W


def block_tridiag_solve(L, W, rhs):
  """H x = rhs from `block_tridiag_cholesky`'s factors; rhs (S, b) or
  (S, b, k)."""
  squeeze = rhs.ndim == 2
  if squeeze:
    rhs = rhs[..., None]
  s_len = rhs.shape[0]
  ys = []
  for s in range(s_len):
    r = rhs[s] if s == 0 else rhs[s] - W[s - 1].T @ ys[-1]
    ys.append(torch.linalg.solve_triangular(L[s], r, upper=False))
  xs = [None] * s_len
  for s in range(s_len - 1, -1, -1):
    r = ys[s] if s == s_len - 1 else ys[s] - W[s] @ xs[s + 1]
    xs[s] = torch.linalg.solve_triangular(L[s].T, r, upper=True)
  x = torch.stack(xs)
  return x[..., 0] if squeeze else x


def srif_gn_solve(A, B, C, r, Ld, L1, L2, rp, reg, Jth=None):
  """Gauss-Newton step by a sweep of block QR factorisations of the
  Jacobian (square-root information filter), never forming J^T J: the
  f32-stable route (cond(J) = sqrt(cond(H)) with cond(H) ~ 1/h^4).

  Rows of the system:
    * stage rows [A_i B_i C_i | Jth_i | r_i] on column blocks (i, i+1,
      i+2), i = 0..T-3;
    * the prior's square-root rows L^T dz + rp (P = L L^T block-banded:
      Ld (T, b, b) diagonal, L1 (T-1, b, b) and L2 (T-2, b, b) below);
    * Levenberg rows sqrt(reg) I on every column block.
  Column blocks are eliminated left to right, then back-substituted.
  Returns (dz (T, b), dtheta (np,))."""
  t_len2, nr, b = A.shape
  t_len = t_len2 + 2
  n_p = Jth.shape[2] if Jth is not None else 0
  dtype, device = A.dtype, A.device
  nc = 2 * b + n_p                       # carried rows
  sreg = torch.sqrt(reg)
  eye_b = torch.eye(b, dtype=dtype, device=device)
  zb = torch.zeros((b, b), dtype=dtype, device=device)
  carry = torch.zeros((nc, 2 * b + n_p + 1), dtype=dtype, device=device)
  heads = []
  for t in range(t_len):
    rows = [torch.cat([carry[:, :2 * b],
                       torch.zeros((nc, b), dtype=dtype, device=device),
                       carry[:, 2 * b:]], dim=1)]
    if t <= t_len - 3:
      stage = [A[t], B[t], C[t]]
      if n_p:
        stage.append(Jth[t])
      rows.append(torch.cat(stage + [r[t][:, None]], dim=1))
    l1 = L1[t] if t < t_len - 1 else zb
    l2 = L2[t] if t < t_len - 2 else zb
    prior = [Ld[t].T, l1.T, l2.T]
    if n_p:
      prior.append(torch.zeros((b, n_p), dtype=dtype, device=device))
    rows.append(torch.cat(prior + [rp[t][:, None]], dim=1))
    rows.append(torch.cat([sreg * eye_b, torch.zeros(
        (b, 2 * b + n_p + 1), dtype=dtype, device=device)], dim=1))
    r_mat = qr_r(torch.cat(rows))
    heads.append(r_mat[:b])
    carry = r_mat[b:b + nc, b:]

  # the parameter border: the last carried rows span (theta, rhs) only
  if n_p:
    mth = torch.cat([carry[:, 2 * b:], torch.cat([
        sreg * torch.eye(n_p, dtype=dtype, device=device),
        torch.zeros((n_p, 1), dtype=dtype, device=device)], dim=1)])
    rth = qr_r(mth)
    dtheta = torch.linalg.solve_triangular(
        rth[:n_p, :n_p], -rth[:n_p, n_p:n_p + 1], upper=True)[:, 0]
  else:
    dtheta = torch.zeros((0,), dtype=dtype, device=device)

  # back-substitution: R_tt x_t = -(y + R01 x_{t+1} + R02 x_{t+2}
  #                                 + Rth dtheta)
  zv = torch.zeros((b,), dtype=dtype, device=device)
  x1 = x2 = zv
  xs = [None] * t_len
  for t in range(t_len - 1, -1, -1):
    head = heads[t]
    rhs = head[:, -1] + head[:, b:2 * b] @ x1 + head[:, 2 * b:3 * b] @ x2
    if n_p:
      rhs = rhs + head[:, 3 * b:3 * b + n_p] @ dtheta
    x_t = torch.linalg.solve_triangular(head[:, :b], -rhs[:, None],
                                        upper=True)[:, 0]
    xs[t] = x_t
    x1, x2 = x_t, x1
  return torch.stack(xs), dtheta


def banded_gn_solve(D1, O1, O2, g, P=None, Q=None, g_theta=None):
  """H dz = -g for a block-pentadiagonal H, optionally bordered by dense
  parameter columns: D1/O1/O2 nv-block band storage, g (T, b); P (T, b,
  np) the parameter coupling, Q (np, np) the parameter block, g_theta
  (np,). The border goes through a Schur complement on the banded factor
  (reference direct.h:291). The system is first equilibrated by
  1/sqrt(diag(H)) with a 1e-4 relative Levenberg jitter, as in the JAX
  package. Returns (dz (T, b), dtheta (np,))."""
  t_len, b = g.shape
  s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(D1, dim1=1, dim2=2),
                                   min=1e-12))                # (T, b)
  D1 = D1 * s[:, :, None] * s[:, None, :]
  O1 = O1 * s[:-1, :, None] * s[1:, None, :]
  O2 = O2 * s[:-2, :, None] * s[2:, None, :]
  g = g * s
  if P is not None:
    P = P * s[:, :, None]
  D1 = D1 + 1e-4 * _eye(b, D1)[None]
  Ds, Us = assemble_superblocks(D1, O1, O2)
  s_len = Ds.shape[0]
  pad = s_len * 2 - t_len

  def to_super(x):
    if pad:
      x = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                    dtype=x.dtype, device=x.device)])
    return x.reshape((s_len, 2 * b) + tuple(x.shape[2:]))

  def from_super(x):
    return x.reshape((s_len * 2, b) + tuple(x.shape[2:]))[:t_len]

  L, W = block_tridiag_cholesky(Ds, Us)
  if P is None:
    dz = block_tridiag_solve(L, W, to_super(-g))
    return from_super(dz) * s, torch.zeros((0,), dtype=g.dtype,
                                           device=g.device)
  rhs = torch.cat([to_super(g)[..., None], to_super(P)], dim=2)
  sol = block_tridiag_solve(L, W, rhs)                       # (S, 2b, 1+np)
  x_g, x_p = sol[..., 0], sol[..., 1:]
  p_s = to_super(P)
  pt_xp = torch.einsum("sbp,sbq->pq", p_s, x_p)
  pt_xg = torch.einsum("sbp,sb->p", p_s, x_g)
  dtheta = torch.linalg.solve_ex(Q - pt_xp, -(g_theta - pt_xg)[:, None])[0]
  dtheta = dtheta[:, 0]
  dz = -x_g - torch.einsum("sbp,p->sb", x_p, dtheta)
  return from_super(dz) * s, dtheta
