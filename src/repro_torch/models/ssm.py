"""Mamba2 (SSD, state-space duality) block [arXiv:2405.21060].

Counterpart of ``repro/models/ssm.py``.  The chunked scan of a full
sequence goes through ``kernels.ssd_scan.ops.ssd_scan``: the CUDA kernel
on the card, its plain version on the CPU.  Single-token decode is plain
PyTorch (no TPU kernel backs it).  The init lives in
``repro_torch/params.py``.

Block dataflow (norm handled by the caller):
  in_proj -> [z | xBC | dt]; causal depthwise conv + silu over xBC;
  split xBC -> x, B, C;  dt = softplus(dt + bias);
  h_t = exp(dt_t A) h_{t-1} + dt_t * B_t (x)  (outer product per head)
  y_t = C_t . h_t + D * x_t
  out = out_proj( rmsnorm(y * silu(z)) )

The kernel takes fp32 only, so the scan's inputs are cast to fp32 at the
call site and its output back to the activations' dtype (a no-op for
fp32 models; the dry run traces bf16).  Under a sharding rule context on
DTensors the projections, the conv and the decode step run as local
regions (``sharding.rules``), the heads shard over "ssm_heads", and the
scan is the custom op ``repro_torch::ssd_scan_fwd`` with its sharding
strategy (``kernels/ssd_scan/ops.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import (  # noqa: F401 (re-exported)
    _segsum, _ssd_inter, ssd_chunked)
from repro_torch.models.common import rms_norm, softplus
from repro_torch.sharding import rules
from repro_torch.sharding.rules import local_region, shard_hint

X_AXES = ("batch", "seq", None)
INNER_AXES = ("batch", "seq", "ssm_inner")


def init_ssm_cache(cfg: ModelConfig, batch: int,
                   dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    nh, hd, S = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    convdim = cfg.d_inner + 2 * cfg.ssm_ngroups * S
    return {
        "state": torch.zeros(batch, nh, hd, S, dtype=torch.float32,
                             device=device),
        "conv": torch.zeros(batch, cfg.ssm_conv - 1, convdim, dtype=dtype,
                            device=device),
    }


def _project_in(p: dict, x: torch.Tensor) -> torch.Tensor:
    return rules.einsum("bsd,dk->bsk", x, p["w_in"], X_AXES,
                        (None, "ssm_inner"), INNER_AXES)


def _split_in(proj: torch.Tensor, cfg: ModelConfig):
    din, G, S = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    z = proj[..., :din]
    xBC = proj[..., din:2 * din + 2 * G * S]
    dt = proj[..., 2 * din + 2 * G * S:]
    return z, xBC, dt


def _conv_full(p: dict, xBC: torch.Tensor, prev: Optional[torch.Tensor]):
    """Causal depthwise conv over seq. prev: [b, w-1, convdim] history.
    The taps are summed in order 0..w-1, as the JAX package sums them."""
    w = p["conv"].shape[0]
    if prev is None:
        prev = torch.zeros(xBC.shape[0], w - 1, xBC.shape[-1],
                           dtype=xBC.dtype, device=xBC.device)
    full = torch.cat([prev, xBC], dim=1)
    s = xBC.shape[1]
    out = sum(full[:, i:i + s] * p["conv"][i] for i in range(w))
    return F.silu(out), full[:, -(w - 1):]


def apply_ssm_full(p: dict, x: torch.Tensor, cfg: ModelConfig,
                   with_cache: bool) -> Tuple[torch.Tensor, Optional[dict]]:
    """Train (with_cache=False) or prefill (True) over a full sequence."""
    b, s, _ = x.shape
    w = {n: p[n] for n in ("conv", "dt_bias", "A_log")}
    z, xh, dt, a_log, Bm, Cm, conv_state = local_region(
        _mix_in_local, (_project_in(p, x), w, cfg),
        (X_AXES, {"conv": (None, None), "dt_bias": (None,),
                  "A_log": (None,)}),
        [X_AXES, X_AXES + (None,), X_AXES, X_AXES, X_AXES + (None,),
         X_AXES + (None,), ("batch", None, None)])
    xh = shard_hint(xh, ("batch", "seq", "ssm_heads", None))
    xdt = (xh.to(torch.float32) * dt[..., None]).to(xh.dtype)
    # the kernel takes fp32: cast its inputs, and its output back below
    y, final = ssd_scan(*(t.to(torch.float32).contiguous()
                          for t in (xdt, a_log, Bm, Cm)), chunk=64)
    y = y + xh.to(torch.float32) * p["D"][None, None, :, None]
    y = y.reshape(b, s, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = rules.einsum("bsk,kd->bsd", y, p["w_out"], INNER_AXES,
                       ("ssm_inner", None), X_AXES)
    if with_cache:
        return out, {"state": final, "conv": conv_state}
    return out, None


def _mix_in_local(proj: torch.Tensor, p: dict, cfg: ModelConfig):
    """The projection split, the causal conv and the scan's inputs of a
    block of sequences: (z, xh [b, s, nh, hd], dt [b, s, nh] fp32, a_log,
    Bm, Cm [b, s, G, S], the conv's last w-1 inputs)."""
    b, s, _ = proj.shape
    G, S, nh, hd = (cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads,
                    cfg.ssm_head_dim)
    z, xBC, dt = _split_in(proj, cfg)
    xBC, conv_state = _conv_full(p, xBC, None)
    xin = xBC[..., :cfg.d_inner]
    Bm = xBC[..., cfg.d_inner:cfg.d_inner + G * S].reshape(b, s, G, S)
    Cm = xBC[..., cfg.d_inner + G * S:].reshape(b, s, G, S)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])  # [b,s,nh]
    A = -torch.exp(p["A_log"])
    a_log = dt * A  # [b, s, nh]
    return z, xin.reshape(b, s, nh, hd), dt, a_log, Bm, Cm, conv_state


def apply_ssm_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     cache: dict) -> Tuple[torch.Tensor, dict]:
    """x [b, 1, d] -> (out [b, 1, d], new cache)."""
    b = x.shape[0]
    w = {n: p[n] for n in ("conv", "dt_bias", "A_log", "D")}
    heads = ("ssm_heads",)
    y, z, new_state, new_conv = local_region(
        _decode_local, (_project_in(p, x), cache["conv"], cache["state"], w,
                        cfg),
        (X_AXES, ("batch", None, None),
         ("batch", "ssm_heads", None, "ssm_state"),
         {"conv": (None, None), "dt_bias": heads, "A_log": heads,
          "D": heads}),
        [("batch", "ssm_heads", None), X_AXES,
         ("batch", "ssm_heads", None, "ssm_state"), ("batch", None, None)])
    y = y.reshape(b, 1, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = rules.einsum("bsk,kd->bsd", y, p["w_out"], INNER_AXES,
                       ("ssm_inner", None), X_AXES)
    return out, {"state": new_state, "conv": new_conv}


def _decode_local(proj: torch.Tensor, conv: torch.Tensor,
                  state: torch.Tensor, p: dict, cfg: ModelConfig):
    """One step of a block of sequences, for this rank's heads of the
    state: (y [b, nh_l, hd] fp32, z, new state, new conv history)."""
    b = proj.shape[0]
    G, S, nh, hd = (cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads,
                    cfg.ssm_head_dim)
    h0, nh_l = rules.local_offset("ssm_heads"), state.shape[1]
    z, xBC, dt = _split_in(proj, cfg)
    # conv over [history | current]
    hist = torch.cat([conv, xBC], dim=1)  # [b, w, convdim]
    conv_out = torch.einsum("bwk,wk->bk", hist, p["conv"])[:, None]
    xBC = F.silu(conv_out)
    new_conv = hist[:, 1:]

    xin = xBC[..., :cfg.d_inner]
    Bm = xBC[..., cfg.d_inner:cfg.d_inner + G * S].reshape(b, G, S)
    Cm = xBC[..., cfg.d_inner + G * S:].reshape(b, G, S)
    dt = dt[:, 0, h0:h0 + nh_l]
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])  # [b,nh]
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)  # [b, nh]
    xh_raw = xin.reshape(b, nh, hd)[:, h0:h0 + nh_l].to(torch.float32)
    xh = xh_raw * dt[..., None]
    hpg = nh // G
    Bh = torch.repeat_interleave(Bm, hpg, dim=1)  # [b, nh, S]
    Ch = torch.repeat_interleave(Cm, hpg, dim=1)
    Bh, Ch = Bh[:, h0:h0 + nh_l], Ch[:, h0:h0 + nh_l]
    new_state = (state * a[..., None, None]
                 + xh[..., None] * Bh[:, :, None, :].to(torch.float32))
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch.to(torch.float32))
    y = y + xh_raw * p["D"][None, :, None]  # skip uses raw x (no dt)
    return y, z, new_state, new_conv
