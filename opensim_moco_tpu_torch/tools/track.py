"""Track tool: controls that reproduce reference states and markers.

Counterpart of ``opensim_moco_tpu.tools.track`` (the reference's
MocoTrack): a ``StateTrackingGoal`` on a reference table (low-passed when
it is a ``StoTable`` and ``lowpass_cutoff`` is set, with speeds from
finite differences on request), a ``MarkerTrackingGoal`` on a .trc
table, a control-effort goal, and the JAX package's solver and IPM
options; solved from the bounds-midpoint guess with the tracked states
written in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ocp import ControlGoal, MarkerTrackingGoal, Problem, Study
from ..ocp.goals import StateTrackingGoal


@dataclasses.dataclass
class Track:
    """Configure and run a tracking problem (JAX ``tools/track.py:19-195``,
    same fields and defaults). ``states_reference`` is ``(times (K,),
    {state_name: values (K,)})`` or a
    :class:`~opensim_moco_tpu_torch.utils.tables.StoTable` whose columns
    are state names; ``markers_reference`` a
    :class:`~opensim_moco_tpu_torch.utils.tables.TrcTable` or the path of
    a .trc file, paired by name with ``model.markers``."""

    model: object = None
    states_reference: object = None
    states_weights: dict = dataclasses.field(default_factory=dict)
    scale_state_weights_with_range: bool = False
    track_reference_position_derivatives: bool = False
    states_global_weight: float = 1.0
    markers_reference: object = None
    markers_weights: dict = dataclasses.field(default_factory=dict)
    markers_global_weight: float = 1.0
    allow_unused_references: bool = False
    control_effort_weight: float = 0.001
    initial_time: float | None = None
    final_time: float | None = None
    mesh_interval: float = 0.02
    convergence_tolerance: float = 1e-2
    max_iterations: int = 2000
    lowpass_cutoff: float | None = None  # Hz
    apply_tracked_states_to_guess: bool = True

    def _finalized_model(self):
        if not self.model._finalized:
            self.model.finalize()
        return self.model

    def _markers_dict(self):
        """``(markers, reference, weights)`` for ``MarkerTrackingGoal``, or
        None without a markers reference: each model marker that has a
        column, with that column's frames where it is not NaN. A column
        with no model marker raises ``ValueError`` unless
        ``allow_unused_references``."""
        if self.markers_reference is None:
            return None
        ref = self.markers_reference
        if isinstance(ref, str):
            from ..utils.tables import read_trc
            ref = read_trc(ref)
        model_markers = self._finalized_model().markers
        unused = [n for n in ref.marker_names if n not in model_markers]
        if unused and not self.allow_unused_references:
            raise ValueError(
                "markers reference contains markers absent from the model "
                f"MarkerSet: {unused[:5]}{'...' if len(unused) > 5 else ''} "
                "(set allow_unused_references=True to ignore them)")
        markers, reference = {}, {}
        for name in ref.marker_names:
            if name not in model_markers:
                continue
            pos = ref.marker(name)
            ok = ~np.any(np.isnan(pos), axis=1)
            if not np.any(ok):
                continue
            markers[name] = model_markers[name]
            reference[name] = (ref.time[ok], pos[ok])
        return markers, reference, dict(self.markers_weights)

    def _reference_dict(self):
        """``(times, {state_name: values})`` of the tracked states (the
        model's states only), or ``(None, None)``."""
        ref = self.states_reference
        if ref is None:
            return None, None
        if hasattr(ref, "column_names"):  # StoTable
            from ..utils.processors import filter_lowpass
            if self.lowpass_cutoff:
                ref = filter_lowpass(ref, self.lowpass_cutoff)
            times = ref.time
            data = {n: ref.column(n) for n in ref.column_names}
        else:
            times, data = ref
            times = np.asarray(times)
        model_states = set(self._finalized_model().state_names())
        data = {n: v for n, v in data.items() if n in model_states}
        if self.track_reference_position_derivatives:
            for name in list(data):
                if name.endswith("/value"):
                    sname = name[:-6] + "/speed"
                    if sname not in data and sname in model_states:
                        data[sname] = np.gradient(np.asarray(data[name]),
                                                  times)
        return times, data

    def make_guess(self, study: Study):
        """The bounds-midpoint guess with the tracked states interpolated
        onto the grid (not clipped to the bounds: the IPM's start moves a
        guess inside them)."""
        tr = study.transcription()
        z = np.array(tr.initial_guess())
        if not self.apply_tracked_states_to_guess or \
                self.states_reference is None:
            return z
        times, data = self._reference_dict()
        ts = z[0] + (z[1] - z[0]) * np.asarray(tr.taus)
        o = tr.offsets["states"]
        Y = z[o[0]:o[1]].reshape(tr.G, tr.ny)
        for name, vals in data.items():
            if name in tr.rep.state_names:
                Y[:, tr.rep.state_names.index(name)] = np.interp(
                    ts, times, np.asarray(vals))
        z[o[0]:o[1]] = Y.ravel()
        return z

    def build_study(self) -> Study:
        times, data = self._reference_dict()
        marker_cfg = self._markers_dict()
        if times is None and marker_cfg is None:
            raise ValueError("Track requires a states_reference and/or a "
                             "markers_reference")
        # the time window: the intersection of the references' ranges
        t0s, tfs = [], []
        if times is not None:
            t0s.append(times[0])
            tfs.append(times[-1])
        if marker_cfg is not None:
            mtimes = [t for t, _ in marker_cfg[1].values()]
            t0s.append(max(t[0] for t in mtimes))
            tfs.append(min(t[-1] for t in mtimes))
        t0 = self.initial_time if self.initial_time is not None \
            else max(t0s)
        tf = self.final_time if self.final_time is not None else min(tfs)

        prob = Problem(self._finalized_model())
        prob.set_time_bounds(t0, tf)
        if times is not None:
            prob.add_goal(StateTrackingGoal(
                name="state_tracking", weight=self.states_global_weight,
                reference={n: (times, v) for n, v in data.items()},
                state_weights=dict(self.states_weights),
                scale_by_range=self.scale_state_weights_with_range))
        if marker_cfg is not None:
            markers, reference, weights = marker_cfg
            prob.add_goal(MarkerTrackingGoal(
                name="marker_tracking", weight=self.markers_global_weight,
                markers=markers, reference=reference,
                marker_weights=weights))
        if self.control_effort_weight:
            prob.add_goal(ControlGoal(name="control_effort",
                                      weight=self.control_effort_weight))

        study = Study(prob)
        n_int = max(2, int(np.ceil((tf - t0) / self.mesh_interval - 1e-12)))
        study.set_solver_options(transcription_scheme="hermite-simpson",
                                 num_mesh_intervals=n_int)
        # the JAX package's options: its KKT-error scaling is stricter than
        # IPOPT's, so the user's tolerance maps to tol/100; the
        # constraints' curvature is dropped, as the reference's
        # limited-memory BFGS never sees it either
        study.set_ipm_options(tol=self.convergence_tolerance * 1e-2,
                              max_iter=self.max_iterations,
                              mu_init=1e-2,
                              hessian_approximation="objective-only")
        return study

    def solve(self, device="cuda", dtype=torch.float64):
        """Build the study and solve it from :meth:`make_guess` on
        ``device`` (the card unless the caller asks for the CPU)."""
        study = self.build_study()
        return study.solve(device, dtype, guess=self.make_guess(study))
