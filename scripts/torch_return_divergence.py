"""Where a candidate's return from the rollout kernel parts from the plain
version's, on the card.

Repeats `chip_smoke.py`'s cost-sum check of one hand task's path build
(phase 8: K=512, H=16, the same seeded candidates from the home pose) and,
for every candidate whose return is off by more than TOL_RETURN_REL
relative, follows it step by step:

  - a states build of the same task and inputs records the kernel's
    rollout; its return is held to the cost-sum build's;
  - the plain version's free-running rollout of the candidate gives the
    error of each step against the kernel's states, and the first step
    where it passes TOL_STEP_QPOS / TOL_STEP_QVEL;
  - at that step, the plain step from the kernel's own pre-step state
    against the kernel's next state, beside NUDGES nudged controls
    (CONTROL_PERTURBATION, relative);
  - the gate: the contact points whose gap changes sign between the
    kernel's and the plain version's states over the step; the contact
    points, joint-limit sides and force-limited actuators within GAP_NEAR
    of their switch before it (gap, distance to the limit less its margin,
    unclamped force to the force range); the dof the departing nudged
    controls' velocity jumps most in.

Usage (prints one JSON object):

    python3 scripts/torch_return_divergence.py [--task cube_solving]

`--device cpu --k 8 --candidates 3` follows a given candidate through the
plain version alone (on the CPU the kernel's wrapper runs it), to try the
script at a small size.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

NUDGES = 16
GAP_NEAR = 1e-4


def main():
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--task", default="cube_solving",
                  choices=sorted(cs.BODY_TASKS))
  ap.add_argument("--device", default="cuda")
  ap.add_argument("--k", type=int, default=cs.K_BODY)
  ap.add_argument("--candidates", type=int, nargs="*",
                  help="follow these (default: those over the tolerance)")
  args = ap.parse_args()
  device = args.device
  import mujoco_mpc_tpu_torch  # noqa: F401  (sets TF32 off)
  from mujoco_mpc_tpu_torch.ops import _build, step_lane
  from mujoco_mpc_tpu_torch.physics.model import HINGE, SLIDE, TRN_JOINT
  from mujoco_mpc_tpu_torch.tasks import registry

  t_start = time.perf_counter()
  tasks = {key: registry.get_task(name, device=device)
           for key, name in cs.BODY_TASKS.items()}
  # the candidates of chip_smoke.py's phase 8, drawn in its order
  rng = np.random.default_rng(cs.SEED + 5)
  values = {}
  for key, task in tasks.items():
    c_ = cs.body_config(task)
    values[key] = cs.planner_candidates(task, args.k,
                                        c_.num_spline_points,
                                        c_.exploration[0], rng, device)
  task = tasks[args.task]
  vals = values[args.task]
  m, spec = task.plan_model, task.lane_residual_spec()
  nq, nv, nu = m.nq, m.nv, m.nu
  p, horizon, k = cs.body_config(task).num_spline_points, cs.HORIZON_BODY, \
      args.k
  select = dict(contact_geoms=getattr(task, "plan_contact_geoms", None),
                body_pairs=True,
                body_pair_types=getattr(task, "plan_body_pair_types", None))
  terms = tuple(zip(task.cost_spec.norm_types, task.cost_spec.dims))
  sums_kern = step_lane.build_rollout_kernel(
      m, horizon, p, residual=spec, naux=spec["naux"], record_states=False,
      cost_terms=terms, **select)
  states_kern = step_lane.build_rollout_kernel(
      m, horizon, p, residual=spec, naux=spec["naux"], record_states=True,
      **select)
  if device != "cpu":
    procs = [_build.start_build("lane_rollout.cu", kern.build_defines())
             for kern in (sums_kern, states_kern)]
    for _, proc in procs:
      _build.finish_build(proc)

  d0 = task.make_data()
  q0 = d0.qpos[:, None].repeat(1, k).contiguous()
  v0 = d0.qvel[:, None].repeat(1, k).contiguous()
  aux_sums = cs.lane_aux(task, spec, d0, k, terms)
  aux = cs.lane_aux(task, spec, d0, k, None)
  w = task.cost_spec.weights[:, None]
  sums, _ = sums_kern(q0, v0, vals, aux_sums)
  sums_p, _ = sums_kern.plain(q0, v0, vals, aux_sums)
  ret = (w * sums).sum(dim=0) / horizon
  ret_p = (w * sums_p).sum(dim=0) / horizon
  rel = (ret - ret_p).abs() / torch.clamp(ret_p.abs(), min=1.0)
  bad = [int(i) for i in torch.nonzero(rel > cs.TOL_RETURN_REL).flatten()]
  followed = bad if args.candidates is None else args.candidates

  rec = states_kern(q0, v0, vals, aux)
  ret_states = task.cost_spec.cost(
      rec[:, nq + nv:].movedim(1, -1)).mean(dim=0)
  gen = torch.Generator(device=device).manual_seed(cs.SEED)
  out = []
  for b in followed:
    col = slice(b, b + 1)
    rec_p = states_kern.plain(q0[:, col], v0[:, col], vals[:, col],
                              aux[:, col])
    mine, plain = rec[:, :nq + nv, b], rec_p[:, :nq + nv, 0]
    err_q = (mine[:, :nq] - plain[:, :nq]).abs().amax(dim=1)
    err_v = (mine[:, nq:] - plain[:, nq:]).abs().amax(dim=1)
    over = (err_q > cs.TOL_STEP_QPOS) | (err_v > cs.TOL_STEP_QVEL)
    row = dict(candidate=b, return_kernel=float(ret[b]),
               return_plain=float(ret_p[b]), rel=float(rel[b]),
               return_states_build=float(ret_states[b]),
               err_qpos_by_step=err_q.tolist(),
               err_qvel_by_step=err_v.tolist())
    if bool(over.any()):
      t1 = int(torch.nonzero(over).flatten()[0])
      s = t1 - 1
      node = min(int(s * p / max(horizon - 1, 1)), p - 1)
      ctrl = vals[node * nu:(node + 1) * nu, col].repeat(1, NUDGES + 1)
      qp = rec[s, :nq, col].repeat(1, NUDGES + 1)
      qv = rec[s, nq:nq + nv, col].repeat(1, NUDGES + 1)
      noise = [1.0 + cs.CONTROL_PERTURBATION * torch.randn(
          x.shape, generator=gen, device=device) for x in (qp, qv)]
      noise[0][:, 0] = noise[1][:, 0] = 1.0
      a_s = aux[:, col].repeat(1, NUDGES + 1)
      nxt = torch.cat(states_kern.step_array(qp * noise[0], qv * noise[1],
                                             ctrl, s, a_s)[:2])
      want, ctl = nxt[:, 0], nxt[:, 1:]
      ctl_q = (ctl[:nq] - want[:nq, None]).abs().amax(dim=0)
      ctl_v = (ctl[nq:] - want[nq:, None]).abs().amax(dim=0)

      def gaps(states):
        return [g for _, _, g in step_lane.contact_gaps(
            m, states[:nq], **select)]

      kinds = [types for types, _, _ in step_lane.contact_gaps(
          m, q0[:, :1], **select)]

      def differ(a, b_):
        return [dict(point=i, types=kinds[i], gap_kernel=float(ga),
                     gap_plain=float(gb))
                for i, (ga, gb) in enumerate(zip(a, b_))
                if bool((ga < 0) != (gb < 0))]

      def limit_gaps(q):
        out_ = []
        for j in range(m.njnt):
          if m.jnt_limited[j] and int(m.jnt_type[j]) in (HINGE, SLIDE):
            qa = int(m.jnt_qposadr[j])
            lo, hi = (float(r) for r in m.jnt_range[j])
            mg = float(m.jnt_margin[j])
            out_ += [(m.names["joint"][j], "lo", float(q[qa]) - lo - mg),
                     (m.names["joint"][j], "hi", hi - float(q[qa]) - mg)]
        return out_

      def clamp_margins(q, v, u_):
        """Each force-limited joint actuator's unclamped force less the
        nearer end of its force range (the position actuators' law)."""
        out_ = []
        for a in range(nu):
          if not (m.actuator_forcelimited[a] and
                  int(m.actuator_trntype[a]) == TRN_JOINT):
            continue
          j = int(m.actuator_trnid[a][0])
          gear = float(m.actuator_gear[a][0])
          length = gear * float(q[int(m.jnt_qposadr[j])])
          vel = gear * float(v[int(m.jnt_dofadr[j])])
          gp, bp = m.actuator_gainprm[a], m.actuator_biasprm[a]
          force = float(gp[0]) * float(u_[a]) + float(bp[0]) + \
              float(bp[1]) * length + float(bp[2]) * vel
          lo, hi = (float(r) for r in m.actuator_forcerange[a])
          out_.append((m.names["actuator"][a],
                       min(force - lo, hi - force)))
        return out_

      before = gaps(rec[s, :, col])
      after_k = gaps(rec[t1, :, col])
      departed = [i for i in range(NUDGES)
                  if not (ctl_q[i] <= cs.TOL_STEP_QPOS and
                          ctl_v[i] <= cs.TOL_STEP_QVEL)]
      jumps = [int((ctl[nq:, i] - want[nq:]).abs().argmax())
               for i in departed]
      row.update(
          first_step_over_tol=t1,
          step_from_kernel_state=dict(
              step=s, err_qpos=float((rec[t1, :nq, b] - want[:nq]).abs()
                                     .max()),
              err_qvel=float((rec[t1, nq:nq + nv, b] - want[nq:]).abs()
                             .max()),
              nudged_err_qpos=ctl_q.tolist(), nudged_err_qvel=ctl_v.tolist(),
              nudged_share_within=float(
                  ((ctl_q <= cs.TOL_STEP_QPOS) &
                   (ctl_v <= cs.TOL_STEP_QVEL)).float().mean())),
          gate=dict(
              # the kernel's state after the step against the plain step
              # from the kernel's state, and against the plain rollout's
              sign_differs_after_step=differ(after_k, gaps(want[:, None])),
              sign_differs_free_running=differ(
                  after_k, gaps(rec_p[t1, :, :1])),
              near_zero_before=[
                  dict(point=i, types=kinds[i], gap=float(g_))
                  for i, g_ in enumerate(before)
                  if abs(float(g_)) < GAP_NEAR],
              limits_near_zero_before=[
                  dict(joint=j, side=side, gap=g_)
                  for j, side, g_ in limit_gaps(rec[s, :nq, b])
                  if abs(g_) < GAP_NEAR],
              force_clamps_near_before=[
                  dict(actuator=a, margin=g_)
                  for a, g_ in clamp_margins(rec[s, :nq, b],
                                             rec[s, nq:nq + nv, b],
                                             ctrl[:, 0])
                  if abs(g_) < GAP_NEAR],
              departed_nudges=departed,
              jump_dof_joint=[m.names["joint"][int(m.dof_jntid[d])]
                              for d in jumps],
              jump_qvel=[float((ctl[nq + d, i] - want[nq + d]))
                         for d, i in zip(jumps, departed)]))
    out.append(row)
  card = cs.card_line() if device != "cpu" else None
  print(json.dumps(dict(
      task=task.name, K=k, H=horizon, tol_return_rel=cs.TOL_RETURN_REL,
      over_tol=bad, followed=followed, max_rel=float(rel.max()),
      max_rel_states_vs_sums=float(
          ((ret_states - ret).abs() / torch.clamp(ret.abs(), min=1.0))
          .max()),
      candidates=out, seconds=time.perf_counter() - t_start, card=card)))


if __name__ == "__main__":
  main()
