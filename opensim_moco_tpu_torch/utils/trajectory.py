"""Trajectory/Solution containers.

Counterpart of ``opensim_moco_tpu.utils.trajectory`` (the reference's
MocoTrajectory/MocoSolution): a dense table of time x {states, controls,
multipliers, derivatives} + parameters, with resampling and RMS
comparison, in numpy. Solutions add solver status and are "sealed" on
failure like the reference: ``state``/``control`` raise unless the solve
succeeded or the user unseals. The spline derivatives of
``generate_*`` are the port's ``CubicSpline`` evaluated on CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .splines import CubicSpline, quintic_resample


def _spline_eval(fn, t):
    """A spline method of the port evaluated at numpy times, as numpy."""
    return fn(torch.as_tensor(np.asarray(t, dtype=np.float64))).numpy()


@dataclasses.dataclass
class Trajectory:
    time: np.ndarray  # (G,)
    state_names: list
    states: np.ndarray  # (G, ny)
    control_names: list
    controls: np.ndarray  # (G, nx)
    multiplier_names: list = dataclasses.field(default_factory=list)
    multipliers: np.ndarray | None = None
    derivative_names: list = dataclasses.field(default_factory=list)
    derivatives: np.ndarray | None = None
    parameter_names: list = dataclasses.field(default_factory=list)
    parameters: np.ndarray | None = None

    def state(self, name):
        return self.states[:, self.state_names.index(name)]

    def control(self, name):
        return self.controls[:, self.control_names.index(name)]

    @property
    def initial_time(self):
        return float(self.time[0])

    @property
    def final_time(self):
        return float(self.time[-1])

    def resample(self, new_time, method="quintic"):
        """Resample all continuous columns onto ``new_time``.

        ``method="quintic"`` (default) matches the reference, which
        resamples through a GCVSplineSet of degree min(5, n-1)
        (MocoTrajectory.h:235 / MocoTrajectory.cpp resampleWithNumTimes);
        ``method="linear"`` matches tropter Iterate::interpolate and is
        kept for piecewise-constant data (e.g. bang-bang controls)."""
        new_time = np.asarray(new_time)

        def interp(table):
            if table is None or table.size == 0:
                return (None if table is None
                        else np.zeros((len(new_time), table.shape[1])))
            if method == "quintic":
                try:
                    return quintic_resample(self.time, table, new_time)
                except (ValueError, np.linalg.LinAlgError):
                    pass  # degenerate grid (duplicate times): fall back
            return np.stack([
                np.interp(new_time, self.time, table[:, j])
                for j in range(table.shape[1])], axis=1)

        return dataclasses.replace(
            self, time=new_time, states=interp(self.states),
            controls=interp(self.controls),
            multipliers=interp(self.multipliers),
            derivatives=interp(self.derivatives))

    def compare_states_rms(self, other: "Trajectory", names=None):
        """RMS over common time range (reference
        compareContinuousVariablesRMS, MocoTrajectory.h:562)."""
        names = names or [n for n in self.state_names
                          if n in other.state_names]
        t_lo = max(self.initial_time, other.initial_time)
        t_hi = min(self.final_time, other.final_time)
        t = np.linspace(t_lo, t_hi, 201)
        a = self.resample(t)
        b = other.resample(t)
        err = np.stack([a.state(n) - b.state(n) for n in names])
        return float(np.sqrt(np.mean(err ** 2)))

    def randomize_add(self, scale=0.1, seed=0):
        """Add uniform noise in [-scale, scale] to states and controls
        (reference MocoTrajectory::randomizeAdd, MocoTrajectory.h:310:
        perturbs an iterate to probe local minima / build guess batches)."""
        rng = np.random.default_rng(seed)

        def noisy(a):
            if a is None or a.size == 0:
                return a
            return a + rng.uniform(-scale, scale, size=a.shape)

        return dataclasses.replace(self, states=noisy(self.states),
                                   controls=noisy(self.controls))

    def generate_speeds_from_values(self):
        """Overwrite each '<coord>/speed' column with the spline derivative
        of its '<coord>/value' column (reference
        generateSpeedsFromValues, MocoTrajectory.h:400)."""
        states = self.states.copy()
        for i, n in enumerate(self.state_names):
            if not n.endswith("/speed"):
                continue
            vname = n[:-len("/speed")] + "/value"
            if vname not in self.state_names:
                continue
            j = self.state_names.index(vname)
            sp = CubicSpline(self.time, self.states[:, j])
            states[:, i] = _spline_eval(sp.derivative, self.time)
        return dataclasses.replace(self, states=states)

    def generate_accelerations_from_speeds(self):
        """Append/overwrite '<coord>/accel' derivative columns with spline
        derivatives of the speeds (reference
        generateAccelerationsFromSpeeds, MocoTrajectory.h:409)."""
        names = []
        cols = []
        for i, n in enumerate(self.state_names):
            if not n.endswith("/speed"):
                continue
            sp = CubicSpline(self.time, self.states[:, i])
            names.append(n[:-len("/speed")] + "/accel")
            cols.append(_spline_eval(sp.derivative, self.time))
        D = (np.stack(cols, axis=1) if cols
             else np.zeros((len(self.time), 0)))
        return dataclasses.replace(self, derivative_names=names,
                                   derivatives=D)

    def generate_accelerations_from_values(self):
        """Append/overwrite '<coord>/accel' derivative columns with second
        spline derivatives of the '<coord>/value' columns (reference
        generateAccelerationsFromValues, MocoTrajectory.h:405)."""
        names = []
        cols = []
        for i, n in enumerate(self.state_names):
            if not n.endswith("/value"):
                continue
            sp = CubicSpline(self.time, self.states[:, i])
            names.append(n[:-len("/value")] + "/accel")
            cols.append(_spline_eval(sp.second_derivative, self.time))
        D = (np.stack(cols, axis=1) if cols
             else np.zeros((len(self.time), 0)))
        return dataclasses.replace(self, derivative_names=names,
                                   derivatives=D)

    def is_compatible(self, state_names, control_names,
                      require_all=False) -> bool:
        """Name-set compatibility with a problem (reference
        MocoTrajectory::isCompatible, MocoTrajectory.h:516)."""
        s_ok = set(self.state_names) >= set(state_names) if require_all \
            else bool(set(self.state_names) & set(state_names)) or \
            not state_names
        c_ok = set(self.control_names) >= set(control_names) if require_all \
            else bool(set(self.control_names) & set(control_names)) or \
            not control_names
        return s_ok and c_ok

    def is_numerically_equal(self, other: "Trajectory", tol=1e-10) -> bool:
        """Strict elementwise equality on shared layout (reference
        isNumericallyEqual, MocoTrajectory.h:534)."""
        if (self.state_names != other.state_names or
                self.control_names != other.control_names or
                self.time.shape != other.time.shape):
            return False
        return (np.allclose(self.time, other.time, atol=tol) and
                np.allclose(self.states, other.states, atol=tol) and
                np.allclose(self.controls, other.controls, atol=tol))

    def compare_controls_rms(self, other: "Trajectory", names=None):
        names = names or [n for n in self.control_names
                          if n in other.control_names]
        t_lo = max(self.initial_time, other.initial_time)
        t_hi = min(self.final_time, other.final_time)
        t = np.linspace(t_lo, t_hi, 201)
        a = self.resample(t)
        b = other.resample(t)
        err = np.stack([a.control(n) - b.control(n) for n in names])
        return float(np.sqrt(np.mean(err ** 2)))


class SealedSolutionError(RuntimeError):
    pass


@dataclasses.dataclass
class Solution(Trajectory):
    """Solver output + stats (MocoSolution analogue,
    MocoTrajectory.h:739-858)."""
    success: bool = False
    status: str = ""
    objective: float = np.nan
    objective_breakdown: dict = dataclasses.field(default_factory=dict)
    num_iterations: int = -1
    solver_duration: float = np.nan
    kkt_error: float = np.nan
    raw_iterate: np.ndarray | None = None  # flat NLP iterate (diagnostics)
    _sealed: bool = False

    def seal(self):
        self._sealed = True
        return self

    def unseal(self):
        self._sealed = False
        return self

    @property
    def sealed(self):
        return self._sealed

    def _check(self):
        if self._sealed:
            raise SealedSolutionError(
                "Solution is sealed (solve failed: %s). Call unseal() to "
                "access anyway." % self.status)

    def state(self, name):
        self._check()
        return super().state(name)

    def control(self, name):
        self._check()
        return super().control(name)


def create_periodic_trajectory(traj: Trajectory, coord_paths_lr=None):
    """Mirror a half-gait-cycle solution into a full cycle
    (reference createPeriodicTrajectory, MocoUtilities.cpp:654: the second
    half swaps _r/_l columns, negates listed anti-symmetric columns, and
    offsets pelvis_tx)."""
    t = traj.time
    t2 = np.concatenate([t, t[1:] + (t[-1] - t[0])])

    def mirror(names, data):
        if data is None or data.size == 0:
            return data
        sw = []
        for n in names:
            if "_r" in n:
                m = n.replace("_r", "_l")
            elif "_l" in n:
                m = n.replace("_l", "_r")
            else:
                m = n
            sw.append(names.index(m) if m in names else names.index(n))
        second = data[1:, sw].copy()
        # pelvis_tx continues forward
        for j, n in enumerate(names):
            if n.endswith("pelvis_tx/value"):
                second[:, j] += data[-1, j] - data[0, j]
        return np.concatenate([data, second], axis=0)

    return dataclasses.replace(
        traj, time=t2,
        states=mirror(traj.state_names, traj.states),
        controls=mirror(traj.control_names, traj.controls),
        multipliers=mirror(traj.multiplier_names, traj.multipliers),
        derivatives=mirror(traj.derivative_names, traj.derivatives))
