"""KKT block structure lowered to padded index arrays.

Counterpart of ``CompiledStructure`` in ``opensim_moco_tpu.solver.kkt``
(the only part of that module the port needs: the IPM factors the
structured KKT with ``solver/structured.py``). Host-side numpy only.
"""

from __future__ import annotations

import numpy as np


class CompiledStructure:
    """KKTStructure lowered to padded index arrays in a given index space.

    Blocks have unequal sizes (the last interval carries the final mesh
    point); they are padded to the maximum and masked. Padded rows and
    columns become identity rows with zero right-hand side, so every
    block of the factorization has the same shape.
    """

    def __init__(self, var_blocks, con_blocks, border_vars, border_cons,
                 n, m):
        N = len(var_blocks)
        assert N == len(con_blocks) and N >= 2
        self.N = N
        nv = max(len(b) for b in var_blocks)
        nc = max((len(b) for b in con_blocks), default=0)
        self.nv, self.nc = nv, nc
        V = np.zeros((N, nv), np.int32)
        Vm = np.zeros((N, nv), bool)
        C = np.zeros((N, nc), np.int32)
        Cm = np.zeros((N, nc), bool)
        for i, b in enumerate(var_blocks):
            V[i, :len(b)] = b
            Vm[i, :len(b)] = True
        for i, b in enumerate(con_blocks):
            C[i, :len(b)] = b
            Cm[i, :len(b)] = True
        self.V, self.Vm, self.C, self.Cm = V, Vm, C, Cm
        self.bv = np.asarray(border_vars, np.int32)
        self.bc = np.asarray(border_cons, np.int32)
        self.n, self.m = n, m
        # coverage check: every index appears exactly once
        all_v = np.concatenate([V[Vm].ravel(), self.bv])
        all_c = np.concatenate([C[Cm].ravel(), self.bc])
        assert len(all_v) == n and len(np.unique(all_v)) == n, \
            (len(all_v), n)
        assert len(all_c) == m and len(np.unique(all_c)) == m, \
            (len(all_c), m)

    def remap_free(self, free_idx):
        """Project onto the free-variable subspace (fixed variables
        eliminated by the solver): drops fixed variable indices and
        renumbers the rest."""
        old_to_new = np.full(self.n, -1, np.int64)
        old_to_new[free_idx] = np.arange(len(free_idx))

        vb = []
        for i in range(self.N):
            new = old_to_new[self.V[i][self.Vm[i]]]
            vb.append(new[new >= 0].tolist())
        bv = old_to_new[self.bv]
        bv = bv[bv >= 0]
        cb = [self.C[i][self.Cm[i]].tolist() for i in range(self.N)]
        return CompiledStructure(vb, cb, bv, self.bc, len(free_idx), self.m)
