"""Precision policy (``twinvoice_tpu.core.precision``): fp32 parity mode vs
bf16 fast mode, on torch dtypes, so every number can state which variant
produced it."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32

    @staticmethod
    def parity():
        return Policy()

    @staticmethod
    def fast():
        return Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)

    def cast_params(self, params):
        from twinvoice_tpu_torch.models.unet import _tree_map  # models imports core

        return _tree_map(lambda a: a.to(self.param_dtype), params)

    def cast_input(self, x):
        return x.to(self.compute_dtype)
