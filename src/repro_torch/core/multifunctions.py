"""``ZMCMultiFunctions`` — the v5.1 headline feature (PyTorch port of
``repro.core.multifunctions``).

Evaluates a collection of integrand families (different forms,
dimensions and boxes) in one shot::

    spec = MultiFunctionSpec.from_families([
        harmonic_family(100, 4),                       # Eq. (1)
        abs_sum_family(49, 2, coeff_a),                # Eq. (2), n < 50
        abs_sum_family(51, 3, coeff_b, sign_last=-1),  # Eq. (2), n >= 50
    ])
    zmc = ZMCMultiFunctions(spec, n_samples=10**6, seed=0, use_kernel=True)
    result = zmc.evaluate(num_trials=10)
    result.trial_mean, result.trial_std   # paper Fig. 1 red band

With ``use_kernel=True`` every family whose form is registered runs in
one fused launch per dim bucket (the CUDA kernel on the card, its plain
version on the CPU); other families take the chunked path.

On a mesh (``mesh=``, a ``DeviceMesh`` from
:mod:`repro_torch.launch.mesh`) every rank runs the same calls: functions
shard over ``fn_axis`` and samples over ``sample_axes``, the fused
buckets through ``multi.sharded_eval_plan`` and the rest through
``direct_mc.sharded_family_sums``, and every rank ends with the same
sums.

Fault tolerance: :meth:`evaluate_resumable` splits the sample budget into
rounds and checkpoints the raw ``(s1, s2, n)`` accumulators after each
round, in ``repro``'s ``.npz`` layout.  The RNG is counter-based, so a
restart continues the exact same sample stream.  On a mesh rank 0 alone
writes the checkpoint; the counters do not depend on the mesh, so a
checkpoint written on one mesh resumes on another or on one device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import direct_mc, rng
from repro_torch.core.integrand import IntegrandFamily, MultiFunctionSpec
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives


@dataclasses.dataclass
class MultiFunctionResult:
    """Per-function estimates, stacked across independent trials."""
    means: np.ndarray     # (num_trials, n_fn_total)
    stderrs: np.ndarray   # (num_trials, n_fn_total) in-trial MC stderr
    n_samples: int
    names: tuple[str, ...]

    @property
    def trial_mean(self) -> np.ndarray:
        """Average over independent trials (paper's bar F_n)."""
        return self.means.mean(axis=0)

    @property
    def trial_std(self) -> np.ndarray:
        """Std over independent trials (paper's triangle F_n)."""
        if self.means.shape[0] < 2:
            return self.stderrs[0]
        return self.means.std(axis=0, ddof=1)


class ZMCMultiFunctions:
    """Multi-function direct-MC integrator (one device or a mesh).

    ``device`` defaults to ``"cuda"`` and raises when there is no GPU;
    pass ``device="cpu"`` for the plain PyTorch path.  With ``mesh`` the
    device is the rank's own (``collectives.mesh_device``).  Families
    with infinite boxes are compactified.  ``sampler`` is ``"mc"`` or
    ``"sobol"`` (randomised QMC, dim <= 8; families above that degrade
    to MC, as in ``repro``).  ``sample_axes`` defaults to every mesh axis
    but ``fn_axis``.
    """

    def __init__(
        self,
        spec: MultiFunctionSpec | Sequence[IntegrandFamily],
        n_samples: int = 10**6,
        seed: int = 0,
        *,
        mesh=None,
        fn_axis: str = "model",
        sample_axes: Sequence[str] | None = None,
        chunk: int = 8192,
        fn_chunk: int | None = None,
        use_kernel: bool = False,
        sampler: str = "mc",          # "mc" | "sobol" (dim <= 8, RQMC)
        device=None,
    ):
        if sampler not in ("mc", "sobol"):
            raise ValueError(f"unknown sampler {sampler!r}")
        if not isinstance(spec, MultiFunctionSpec):
            spec = MultiFunctionSpec.from_families(spec)
        self.mesh = mesh
        self.fn_axis = fn_axis
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = collectives.mesh_device(mesh, device)
            if sample_axes is None:
                sample_axes = tuple(a for a in mesh.mesh_dim_names if a != fn_axis)
        self.sample_axes = tuple(sample_axes) if sample_axes else ("data",)
        # infinite domains are rewritten into finite boxes up-front
        self.spec = MultiFunctionSpec(families=tuple(
            f.compactified() for f in spec.to(self.device).families))
        self.n_samples = int(n_samples)
        self.seed = int(seed)
        self.chunk = int(chunk)
        self.fn_chunk = fn_chunk
        self.use_kernel = bool(use_kernel)
        self.sampler = sampler
        self._fusion_plan = None

    # -- single-trial sums ----------------------------------------------------
    def _get_fusion_plan(self):
        """Bucketed fused-kernel plan for the whole spec (built once)."""
        if self._fusion_plan is None:
            from repro_torch.kernels.mc_eval import multi
            self._fusion_plan = multi.plan_spec(self.spec, sampler=self.sampler)
        return self._fusion_plan

    def _trial_sums(self, trial: int, n_samples: int, sample_offset: int):
        """Raw per-function sums for one independent trial."""
        key = rng.fold_key(self.seed, trial)
        fused = {}
        if self.use_kernel:
            from repro_torch.kernels.mc_eval import multi
            if self.mesh is None:
                fused = multi.eval_plan(self._get_fusion_plan(), n_samples, key,
                                        sample_offset=sample_offset)
            else:
                fused = multi.sharded_eval_plan(
                    self._get_fusion_plan(), n_samples, key, self.mesh,
                    fn_axis=self.fn_axis, sample_axes=self.sample_axes,
                    sample_offset=sample_offset)
        out = []
        offsets = self.spec.offsets()
        for idx, (fam, off) in enumerate(zip(self.spec.families, offsets)):
            if idx in fused:
                out.append(fused[idx])
                continue
            if self.mesh is not None:
                sums, _ = direct_mc.sharded_family_sums(
                    fam, n_samples, key, self.mesh, fn_axis=self.fn_axis,
                    sample_axes=self.sample_axes, fn_offset=off,
                    sample_offset=sample_offset, chunk=self.chunk,
                    use_kernel=self.use_kernel, sampler=self.sampler)
                out.append(direct_mc.SumsState(s1=sums.s1[:fam.n_fn],
                                               s2=sums.s2[:fam.n_fn], n=sums.n))
                continue
            out.append(direct_mc.family_sums(
                fam, n_samples, key, fn_offset=off,
                sample_offset=sample_offset, chunk=self.chunk,
                fn_chunk=self.fn_chunk, use_kernel=self.use_kernel,
                sampler=self.sampler))
        return out

    # -- public API ------------------------------------------------------------
    def evaluate(self, num_trials: int = 1) -> MultiFunctionResult:
        """Run ``num_trials`` independent evaluations of every integrand."""
        means, stderrs = [], []
        for t in range(num_trials):
            m, s = self._finalize(self._trial_sums(t, self.n_samples, 0))
            means.append(m)
            stderrs.append(s)
        return MultiFunctionResult(
            means=np.stack(means), stderrs=np.stack(stderrs),
            n_samples=self.n_samples,
            names=tuple(f.name for f in self.spec.families))

    def _finalize(self, sums_per_family):
        m, s = [], []
        for fam, sums in zip(self.spec.families, sums_per_family):
            res = direct_mc.finalize(fam, sums)
            m.append(res.mean.cpu().numpy())
            s.append(res.stderr.cpu().numpy())
        return np.concatenate(m), np.concatenate(s)

    # -- fault-tolerant evaluation ----------------------------------------------
    def _ckpt_tag(self) -> str:
        blob = json.dumps({
            "n_samples": self.n_samples, "seed": self.seed,
            "families": [(f.name, f.n_fn, f.dim) for f in self.spec.families],
        }, sort_keys=True).encode()
        return hashlib.sha1(blob).hexdigest()[:12]

    def evaluate_resumable(
        self,
        rounds: int = 8,
        checkpoint_dir: str | None = None,
        trial: int = 0,
        fail_after_round: int | None = None,
    ) -> MultiFunctionResult:
        """Evaluate one trial in ``rounds`` checkpointed increments.

        ``fail_after_round`` injects a crash (for the fault-tolerance
        tests); re-calling with the same ``checkpoint_dir`` resumes and
        produces sums identical to an uninterrupted run.  On a mesh every
        rank reads the checkpoint, rank 0 alone writes it, and a barrier
        follows each write (``checkpoint_dir`` must be one directory all
        ranks see).
        """
        per_round = -(-self.n_samples // rounds)  # ceil
        state = None   # list[SumsState] per family
        start_round = 0
        path = None
        if checkpoint_dir is not None:
            os.makedirs(checkpoint_dir, exist_ok=True)
            path = os.path.join(checkpoint_dir,
                                f"zmc_{self._ckpt_tag()}_t{trial}.npz")
            if os.path.exists(path):
                with np.load(path) as data:
                    start_round = int(data["round"])
                    state = [direct_mc.SumsState(
                        *(torch.from_numpy(np.asarray(data[f"{k}_{i}"])).to(
                            self.device) for k in ("s1", "s2", "n")))
                        for i in range(len(self.spec.families))]

        for r in range(start_round, rounds):
            n_this = min(per_round, self.n_samples - r * per_round)
            if n_this <= 0:
                break
            sums = self._trial_sums(trial, n_this, r * per_round)
            if state is None:
                state = list(sums)
            else:
                state = [direct_mc.merge_sums(a, b) for a, b in zip(state, sums)]
            if path is not None:
                if self.mesh is None or dist.get_rank() == 0:
                    payload = {"round": r + 1}
                    for i, st in enumerate(state):
                        payload[f"s1_{i}"] = st.s1.cpu().numpy()
                        payload[f"s2_{i}"] = st.s2.cpu().numpy()
                        payload[f"n_{i}"] = st.n.cpu().numpy()
                    tmp = path + ".tmp.npz"
                    np.savez(tmp, **payload)
                    os.replace(tmp, path)
                if self.mesh is not None:
                    collectives.barrier(self.mesh)
            if fail_after_round is not None and r == fail_after_round:
                raise RuntimeError(f"injected failure after round {r}")

        m, s = self._finalize(state)
        return MultiFunctionResult(
            means=m[None], stderrs=s[None], n_samples=self.n_samples,
            names=tuple(f.name for f in self.spec.families))
