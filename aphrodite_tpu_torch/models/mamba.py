"""Mamba-family decoders (Mamba, FalconMamba, Mamba-2) in PyTorch.

Counterpart of the JAX package's ``models/mamba.py``. There is no paged KV
cache: each request's recurrent state lives in two slot-indexed buffers,
``conv`` [L, slots, K-1, conv width] in the model's dtype and ``ssm``
[L, slots, ...state] in fp32, and ``md.state_slots`` routes request r to
its slot. The scheduled tokens lie back to back (``md.query_start_loc``,
``md.seg_starts``); one forward serves any mix of fresh prefills, resumed
chunks and one-token decode rows:

- the depthwise causal conv reads the taps before a segment's first token
  from the slot's conv state, when the segment resumes (position > 0);
- the selective scan (``ops/selective_scan.py``: the hand-written CUDA
  kernel on the card) runs over the whole flat layout; each segment's
  first token gets dA = 0 and the slot's resumed state folded into dBx,
  so no state leaks from one request to the next.

Weights keep the JAX package's leaf names and layouts (``in_proj`` [H, ·],
``conv_w`` [K, width] with ``conv_w[K-1-s]`` on ``x[t-s]``, ``A_log`` in
fp32), so ``loader.weights.params_from_jax`` is a rename. The casts follow
the JAX package's: the projections sum in fp32 and round to the
activation dtype, dt's projection is a product in that dtype with fp32
sums, and the scan, y and the gate run in fp32.

The states are updated in place (``index_copy_`` on the requests' slots)
where the JAX package donates its buffers. Rows with ``seq_lens == 0``
(frozen decode rows) write neither state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from aphrodite_tpu_torch.attention.metadata import AttentionMetadata
from aphrodite_tpu_torch.config import ModelConfig
from aphrodite_tpu_torch.layers.common import rms_norm
from aphrodite_tpu_torch.layers.linear import matmul_f32
from aphrodite_tpu_torch.ops.selective_scan import selective_scan
from aphrodite_tpu_torch.utils import torch_dtype


@dataclass
class SsmRouting:
    """Per-forward index tensors that every layer shares (the JAX package
    recomputes them in each layer; XLA hoists them)."""
    # [T] bool live tokens, or None when every token is live.
    valid: Optional[torch.Tensor]
    # [K-1] x [T] int64: row of x[t - s] for s = 1..K-1 in the tap source
    # [x; conv state rows; a zero row] (see ``_conv``).
    tap_idx: list
    # [R * (K-1)] int64: rows of the new conv state, oldest first.
    new_idx: torch.Tensor
    seg: torch.Tensor       # [R] int64 first flat token of each request
    slots: torch.Tensor     # [R] int64 state slot of each request
    ends: torch.Tensor      # [R] int64 last flat token of each request
    resume: torch.Tensor    # [R] bool: the segment starts past position 0
    live: torch.Tensor      # [R] bool: seq_lens > 0 (writes its state)


class MambaLayer(nn.Module):
    """One layer's leaves, named as in the JAX package's tree."""

    def __init__(self, shapes: dict[str, tuple], dtype, device) -> None:
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.empty(
                shape, dtype=torch.float32 if name == "A_log" else dtype,
                device=device), requires_grad=False))


class MambaForCausalLM(nn.Module):
    """Pure Mamba-1 stack (HF ``MambaForCausalLM`` geometry)."""

    is_ssm = True

    def __init__(self, config: ModelConfig,
                 device: torch.device | str = "cpu",
                 quant_config=None) -> None:
        super().__init__()
        if quant_config is not None:
            raise NotImplementedError("quantized Mamba weights are not "
                                      "ported")
        self.config = config
        self.dtype = torch_dtype(config.dtype)
        self.hidden_size = config.hidden_size
        self.num_layers = config.num_layers
        self.vocab_size = config.vocab_size
        self.d_inner = config.get("intermediate_size") or 2 * self.hidden_size
        self.d_state = config.get("state_size", 16)
        self.d_conv = config.get("conv_kernel", 4)
        self.dt_rank = config.get("time_step_rank")
        if self.dt_rank is None or self.dt_rank == "auto":
            self.dt_rank = -(-self.hidden_size // 16)
        self.use_conv_bias = config.get("use_conv_bias", True)
        self.use_bias = config.get("use_bias", False)
        self.rms_eps = config.get("layer_norm_epsilon", 1e-5)
        self.tie_embeddings = config.get("tie_word_embeddings", True)
        # FalconMamba: parameterless RMS over the dt/B/C selection outputs.
        self.bcdt_rms_eps = (config.get("mixer_rms_eps", 1e-6)
                             if config.get("model_type") == "falcon_mamba"
                             else None)
        self._geometry(config)
        mk = dict(dtype=self.dtype, device=device)
        H = self.hidden_size
        self.embed = nn.Parameter(torch.empty((self.vocab_size, H), **mk),
                                  requires_grad=False)
        self.layers = nn.ModuleList([
            MambaLayer(self._layer_shapes(), self.dtype, device)
            for _ in range(self.num_layers)])
        self.final_norm = nn.Parameter(torch.empty((H,), **mk),
                                       requires_grad=False)
        self.lm_head = (None if self.tie_embeddings else nn.Parameter(
            torch.empty((H, self.vocab_size), **mk), requires_grad=False))

    def _geometry(self, config: ModelConfig) -> None:
        """Hook: Mamba-2 sets its head geometry here."""
        self.conv_dim = self.d_inner

    def _layer_shapes(self) -> dict[str, tuple]:
        H, Di, Ds, R, K = (self.hidden_size, self.d_inner, self.d_state,
                           self.dt_rank, self.d_conv)
        shapes = {
            "norm": (H,), "in_proj": (H, 2 * Di), "conv_w": (K, Di),
            "x_proj": (Di, R + 2 * Ds), "dt_w": (R, Di), "dt_b": (Di,),
            "A_log": (Di, Ds), "D": (Di,), "out_proj": (Di, H),
        }
        if self.use_conv_bias:
            shapes["conv_b"] = (Di,)
        if self.use_bias:
            shapes["in_b"] = (2 * Di,)
            shapes["out_b"] = (H,)
        return shapes

    def _ssm_state_shape(self) -> tuple:
        return (self.d_inner, self.d_state)

    # ------------------------------------------------------------- state cache
    def init_cache(self, num_slots: int) -> dict[str, torch.Tensor]:
        """Zeroed recurrent-state buffers (the ssm state is fp32, like the
        reference's selective-scan accumulator)."""
        dev = self.embed.device
        L = self.num_layers
        return {
            "conv": torch.zeros((L, num_slots, self.d_conv - 1,
                                 self.conv_dim), dtype=self.dtype,
                                device=dev),
            "ssm": torch.zeros((L, num_slots) + self._ssm_state_shape(),
                               dtype=torch.float32, device=dev),
        }

    # ------------------------------------------------------------------ params
    @torch.no_grad()
    def init_dummy_params(self, generator: torch.Generator) -> None:
        """The JAX package's dummy recipe: N(0, 0.02) drawn in fp32, ones
        for ``norm``, ``D`` and the final norm, zeros for ``*_b`` biases,
        ``A_log = log(1..n)`` along its last axis. The generator must live
        on the parameters' device."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("norm", "D", "final_norm"):
                p.fill_(1.0)
            elif leaf == "A_log":
                p.copy_(torch.log(torch.arange(
                    1, p.shape[-1] + 1, dtype=torch.float32,
                    device=p.device)).expand(p.shape))
            elif leaf.endswith("_b"):
                p.zero_()
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=generator,
                                           device=p.device))

    # ----------------------------------------------------------------- forward
    def _routing(self, md: AttentionMetadata, T: int,
                 num_slots: int) -> SsmRouting:
        """The conv's tap rows and the state routing, from the metadata
        (``mamba.py:205-268`` of the JAX package, as row indices)."""
        K = self.d_conv
        dev = md.token_pos.device
        t_idx = torch.arange(T, device=dev)
        seg = md.seg_starts.long()
        slots = md.state_slots.long()
        req = md.token_req_idx.long()
        seg_t, slot_t = seg[req], slots[req]
        resume = md.token_pos[seg] > 0                       # [R]
        resume_t = resume[req]
        zero_row = T + num_slots * (K - 1)

        def rows(prev, start, slot, resumed):
            # x[prev] of a segment starting at `start`: from the scheduled
            # tokens, else from the conv state's row for that input (the
            # state holds the K-1 inputs before the segment, newest last)
            # when the segment resumes, else 0.
            from_seq = prev >= start
            back = start - prev                # >= 1 when from the state
            use_state = ~from_seq & (back <= K - 1) & resumed
            state_row = T + slot * (K - 1) + (K - 1 - back).clamp(0, K - 2)
            return torch.where(from_seq, prev.clamp(min=0), torch.where(
                use_state, state_row, zero_row))

        tap_idx = [rows(t_idx - s, seg_t, slot_t, resume_t)
                   for s in range(1, K)]
        seg_end = md.query_start_loc[1:].long()
        # The segment's last K-1 inputs, oldest first.
        new_idx = torch.stack([rows(seg_end - j, seg, slots, resume)
                               for j in range(K - 1, 0, -1)], dim=1)
        return SsmRouting(
            valid=md.token_valid, tap_idx=tap_idx,
            new_idx=new_idx.reshape(-1), seg=seg, slots=slots,
            ends=(seg_end - 1).clamp(min=0), resume=resume,
            live=md.seq_lens > 0)

    @staticmethod
    def _mask(x: torch.Tensor, rt: SsmRouting) -> torch.Tensor:
        if rt.valid is None:
            return x
        return x.masked_fill(~rt.valid.view(-1, *[1] * (x.dim() - 1)), 0.0)

    def _conv(self, xin: torch.Tensor, conv_w: torch.Tensor,
              conv_b: Optional[torch.Tensor], conv_st: torch.Tensor,
              rt: SsmRouting) -> torch.Tensor:
        """Depthwise causal conv over [T, W] inputs -> fp32 [T, W] (before
        the activation); writes each live request's last K-1 inputs into
        its conv state."""
        K = self.d_conv
        w = conv_w.float()
        src = torch.cat([xin, conv_st.reshape(-1, xin.shape[1]).to(xin.dtype),
                         xin.new_zeros((1, xin.shape[1]))])
        acc = xin.float() * w[K - 1]
        for s in range(1, K):
            acc = acc + src[rt.tap_idx[s - 1]].float() * w[K - 1 - s]
        if conv_b is not None:
            acc = acc + conv_b.float()
        R = rt.slots.shape[0]
        new = src[rt.new_idx].reshape(R, K - 1, -1).to(conv_st.dtype)
        conv_st.index_copy_(0, rt.slots, torch.where(
            rt.live[:, None, None], new, conv_st[rt.slots]))
        return acc

    def _scan(self, dA: torch.Tensor, dBx: torch.Tensor,
              ssm_st: torch.Tensor, rt: SsmRouting) -> torch.Tensor:
        """Segment isolation, the scan, and the live requests' final states.
        dA and dBx are fresh [T, ...] fp32 tensors, changed in place."""
        bcast = (-1,) + (1,) * (dA.dim() - 1)
        first = rt.seg
        # The first token of each segment applies its decay to the slot's
        # resumed state (0 at position 0) and restarts the carry.
        h0 = torch.where(rt.resume.view(bcast), ssm_st[rt.slots], 0.0)
        dBx[first] = dBx[first] + dA[first] * h0
        dA[first] = 0.0
        if rt.valid is not None:
            invalid = ~rt.valid.view(bcast)
            dA.masked_fill_(invalid, 0.0)
            dBx.masked_fill_(invalid, 0.0)
        hs = selective_scan(dA, dBx)
        ssm_st.index_copy_(0, rt.slots, torch.where(
            rt.live.view(bcast), hs[rt.ends], ssm_st[rt.slots]))
        return hs

    def _mixer(self, x: torch.Tensor, lp: MambaLayer, conv_st: torch.Tensor,
               ssm_st: torch.Tensor, rt: SsmRouting) -> torch.Tensor:
        """One Mamba-1 block over the flat token layout: x [T, H]."""
        Di, Ds, R = self.d_inner, self.d_state, self.dt_rank
        proj = matmul_f32(x, lp.in_proj).to(x.dtype)
        in_b = getattr(lp, "in_b", None)
        if in_b is not None:
            proj = proj + in_b
        h = self._mask(proj[:, :Di], rt)
        gate = proj[:, Di:]
        acc = self._conv(h, lp.conv_w, getattr(lp, "conv_b", None), conv_st,
                         rt)
        hc = self._mask(F.silu(acc).to(x.dtype), rt)

        ssm_p = matmul_f32(hc, lp.x_proj)
        dt, B, C = ssm_p[:, :R], ssm_p[:, R:R + Ds], ssm_p[:, R + Ds:]
        if self.bcdt_rms_eps is not None:
            dt, B, C = (v * torch.rsqrt(v.pow(2).mean(-1, keepdim=True)
                                        + self.bcdt_rms_eps)
                        for v in (dt, B, C))
        dt = F.softplus(matmul_f32(dt.to(x.dtype), lp.dt_w)
                        + lp.dt_b.float())                      # [T, Di]
        A = -torch.exp(lp.A_log)                                # [Di, Ds]
        dA = torch.exp(dt[:, :, None] * A)                      # [T, Di, Ds]
        dBx = dt[:, :, None] * B[:, None, :]
        dBx.mul_(hc.float()[:, :, None])
        hs = self._scan(dA, dBx, ssm_st, rt)
        del dA, dBx
        y = torch.bmm(hs, C[:, :, None])[:, :, 0]               # [T, Di]
        del hs
        y = y + hc.float() * lp.D.float()
        y = (y * F.silu(gate.float())).to(x.dtype)
        out = matmul_f32(y, lp.out_proj).to(x.dtype)
        out_b = getattr(lp, "out_b", None)
        if out_b is not None:
            out = out + out_b
        return out

    def forward(self, input_ids: torch.Tensor, state: dict,
                md: AttentionMetadata) -> torch.Tensor:
        """[T] token ids -> [T, H] final hidden; ``state`` ({"conv", "ssm"}
        of ``init_cache``) is updated in place."""
        conv, ssm = state["conv"], state["ssm"]
        rt = self._routing(md, input_ids.shape[0], conv.shape[1])
        x = self.embed[input_ids]
        for li, layer in enumerate(self.layers):
            h = rms_norm(x, layer.norm, self.rms_eps)
            x = x + self._mixer(h, layer, conv[li], ssm[li], rt)
        return rms_norm(x, self.final_norm, self.rms_eps)

    def compute_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """[N, H] -> [N, V] float32 logits, accumulated in fp32."""
        head = self.embed.t() if self.tie_embeddings else self.lm_head
        return matmul_f32(hidden, head)


class FalconMambaForCausalLM(MambaForCausalLM):
    """FalconMamba: Mamba-1 with a parameterless RMS over the dt/B/C
    selection outputs (set from ``mixer_rms_eps`` when ``model_type`` is
    ``falcon_mamba``)."""


class Mamba2ForCausalLM(MambaForCausalLM):
    """Mamba-2 (SSD) as the same ragged scan: per head a scalar decay
    exp(dt * A_h), a [head_dim, state] state, B/C in ``n_groups`` shared
    across heads, and a z-gated RMSNorm before ``out_proj``."""

    def _geometry(self, config: ModelConfig) -> None:
        self.d_inner = config.get("expand", 2) * self.hidden_size
        self.n_heads = config.get("num_heads")
        self.head_dim_m2 = config.get("head_dim")
        self.n_groups = config.get("n_groups", 1)
        self.conv_dim = self.d_inner + 2 * self.n_groups * self.d_state
        self.dt_limit = tuple(config.get("time_step_limit",
                                         (0.0, float("inf"))))

    def _layer_shapes(self) -> dict[str, tuple]:
        H, Di, nh, K = self.hidden_size, self.d_inner, self.n_heads, \
            self.d_conv
        return {
            "norm": (H,), "in_proj": (H, Di + self.conv_dim + nh),
            "conv_w": (K, self.conv_dim), "conv_b": (self.conv_dim,),
            "dt_bias": (nh,), "A_log": (nh,), "D": (nh,),
            "gated_norm_w": (Di,), "out_proj": (Di, H),
        }

    def _ssm_state_shape(self) -> tuple:
        return (self.n_heads, self.head_dim_m2, self.d_state)

    def _mixer(self, x: torch.Tensor, lp: MambaLayer, conv_st: torch.Tensor,
               ssm_st: torch.Tensor, rt: SsmRouting) -> torch.Tensor:
        T = x.shape[0]
        Di, Ds, cd = self.d_inner, self.d_state, self.conv_dim
        nh, hd, G = self.n_heads, self.head_dim_m2, self.n_groups
        proj = matmul_f32(x, lp.in_proj).to(x.dtype)
        gate = proj[:, :Di]
        xbc = self._mask(proj[:, Di:Di + cd], rt)
        dt_in = proj[:, Di + cd:].float()                       # [T, nh]
        acc = self._conv(xbc, lp.conv_w, lp.conv_b, conv_st, rt)
        xbc_c = self._mask(F.silu(acc), rt)
        h = xbc_c[:, :Di].reshape(T, nh, hd)
        rep = nh // G
        B = xbc_c[:, Di:Di + G * Ds].reshape(T, G, Ds).repeat_interleave(
            rep, dim=1)                                         # [T, nh, Ds]
        C = xbc_c[:, Di + G * Ds:].reshape(T, G, Ds).repeat_interleave(
            rep, dim=1)

        dt = F.softplus(dt_in + lp.dt_bias.float())
        dt = dt.clamp(self.dt_limit[0], self.dt_limit[1])       # [T, nh]
        A = -torch.exp(lp.A_log)                                # [nh]
        dBx = (dt[:, :, None] * B)[:, :, None, :] \
            * h.float()[:, :, :, None]                          # [T,nh,hd,Ds]
        dA = torch.exp(dt * A)[:, :, None, None].expand(
            dBx.shape).contiguous()
        hs = self._scan(dA, dBx, ssm_st, rt)
        del dA, dBx
        y = torch.matmul(hs, C[:, :, :, None])[..., 0]          # [T, nh, hd]
        del hs
        y = y + h.float() * lp.D.float()[None, :, None]
        y = y.reshape(T, Di) * F.silu(gate.float())
        y = y * torch.rsqrt(y.pow(2).mean(-1, keepdim=True) + self.rms_eps)
        y = (y * lp.gated_norm_w.float()).to(x.dtype)
        return matmul_f32(y, lp.out_proj).to(x.dtype)

