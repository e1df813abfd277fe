"""The plain reference that decides ``correct``: the model of each family
(``families/<family>.py``), its loss, the gradient, its global-norm clip and AdamW, in fp32 PyTorch.

It imports nothing of the program. It follows the configuration as stated:
the parameters are stored in their stated types (bf16, and fp32 for the
SSD's ``dt_bias``, ``A_log`` and ``D_skip``), so each update is rounded to
that type; every product, norm, softmax and reduction is computed in fp32,
with TF32 off. The layers here, leaf by leaf (a leaf named as in the
program's tree, matrices laid out (in, out)); how a family stacks them is
its file under ``families/``:

- rmsnorm(x) = x / sqrt(mean(x^2) + eps) * scale;
- attention over q = x wq, k = x wk, v = x wv in heads of ``head_dim``,
  RoPE on the split halves (angles pos / theta^(2i/hd)), causal
  softmax(q k^T / sqrt(hd)), the heads' outputs times wo;
- mlp as ``act`` says: swiglu (silu(x gate) * (x up)) down, geglu
  (gelu(x gate) * (x up)) down, gelu gelu(x up) down, gelu by its tanh form;
- ssm(x) (Mamba2): z = x in_z; xs, B, C = silu(causal depthwise conv of
  x in_x, x in_B, x in_C); dt = softplus(x in_dt + dt_bias); A = -exp(A_log);
  the SSD recurrence s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T, y_t = s_t C_t,
  computed by chunks; y += D_skip x; out = rmsnorm_gate(y * silu(z)) out;
- the head: the final norm, then h lm_head (or h table^T when tied), over the
  padded vocabulary; the loss the mean of logsumexp minus the target's logit;
- a step: the mean of the micro-batches' gradients (and losses), the global
  norm clipped to ``grad_clip``, AdamW (``beta1``, ``beta2`` of the
  configuration's ``train``, eps 1e-8, decay added to the step, bias
  correction by the step count).

Memory: every layer, every block of attention heads and every block of the
loss's rows is recomputed in the backward (``torch.utils.checkpoint``), so a
full-width step fits one card beside its fp32 state.

``Reference(model, train, quant="fp8")`` is the control: each operand of
each product rounded to float8 e4m3 with a per-tensor scale, and its
gradient to e5m2, the precision below the stated bf16.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import families
from portbench import weights as W

EPS = 1e-8                  # AdamW's, which the configurations do not state
# fp32 elements of one block of attention scores, or of the loss's logits
BLOCK_ELEMS = 1 << 27


def _round8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    s = top / x.detach().abs().amax().clamp(min=1e-30)
    return (x * s).to(dtype).float() / s


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, 57344.0)


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


class Reference:
    def __init__(self, model: Dict, train: Dict, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant is None or 'fp8', got {quant!r}")
        self.m, self.t = model, train
        self.quant = quant
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # -- products -----------------------------------------------------------
    def _q(self, x):
        return _Fp8.apply(x) if self.quant else x

    def mm(self, a, w):
        return self._q(a) @ self._q(w)

    def ein(self, eq, *ops):
        return torch.einsum(eq, *[self._q(o) for o in ops])

    # -- layers --------------------------------------------------------------
    @staticmethod
    def remat(fn, *args):
        """``fn(*args)``, recomputed in the backward."""
        return _ckpt(fn, *args)

    def rms(self, x, scale):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.m["norm_eps"]) * scale

    def rope(self, x, S):
        hd = x.shape[-1]
        freqs = 1.0 / (self.m["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                                              device=x.device) / hd))
        ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def _scores_block(self, q, k, v):
        """Causal attention of one block of heads, (B, h, S, d)."""
        S = q.shape[2]
        s = self.ein("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
        tri = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~tri, float("-inf"))
        return self.ein("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)

    def attention(self, p, x):
        m = self.m
        B, S, _ = x.shape
        H, KH, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        q = self.rope(self.mm(x, p["wq"]).view(B, S, H, hd), S).transpose(1, 2)
        k = self.rope(self.mm(x, p["wk"]).view(B, S, KH, hd), S).transpose(1, 2)
        v = self.mm(x, p["wv"]).view(B, S, KH, hd).transpose(1, 2)
        k = k.repeat_interleave(H // KH, dim=1)
        v = v.repeat_interleave(H // KH, dim=1)
        hb = max(1, min(H, BLOCK_ELEMS // (B * S * S)))
        out = torch.cat([_ckpt(self._scores_block, q[:, i:i + hb], k[:, i:i + hb],
                               v[:, i:i + hb]) for i in range(0, H, hb)], dim=1)
        return self.mm(out.transpose(1, 2).reshape(B, S, H * hd), p["wo"])

    def mlp(self, p, x):
        act = self.m["act"]
        if act == "swiglu":
            h = F.silu(self.mm(x, p["gate"])) * self.mm(x, p["up"])
        elif act == "geglu":
            h = F.gelu(self.mm(x, p["gate"]), approximate="tanh") * self.mm(x, p["up"])
        elif act == "gelu":
            h = F.gelu(self.mm(x, p["up"]), approximate="tanh")
        else:
            raise ValueError(f"no reference for act {act!r}")
        return self.mm(h, p["down"])

    @staticmethod
    def conv(u, w):
        K, S = w.shape[0], u.shape[1]
        pad = F.pad(u, (0, 0, K - 1, 0))
        return sum(pad[:, i:i + S, :] * w[i] for i in range(K))

    def ssd(self, x, dA, Bm, Cm):
        """x (B,S,H,P) dt-scaled, dA (B,S,H) log-decays, Bm/Cm (B,S,G,N); y (B,S,H,P)."""
        Bsz, S, H, P = x.shape
        G, N = Bm.shape[2], Bm.shape[3]
        R = H // G
        Q = min(self.m["ssm_chunk"], S)
        tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        state = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=x.device)
        ys = []
        for c0 in range(0, S, Q):
            xc, ac = x[:, c0:c0 + Q], dA[:, c0:c0 + Q]
            Bc = Bm[:, c0:c0 + Q].repeat_interleave(R, dim=2)
            Cc = Cm[:, c0:c0 + Q].repeat_interleave(R, dim=2)
            cum = ac.cumsum(dim=1)                                     # (B,Q,H)
            seg = cum[:, :, None, :] - cum[:, None, :, :]              # (B,Qt,Qs,H)
            L = seg.masked_fill(~tri[None, :, :, None], float("-inf")).exp()
            cb = self.ein("bthn,bshn->btsh", Cc, Bc)
            y = self.ein("btsh,bshp->bthp", cb * L, xc)
            y = y + self.ein("bthn,bhpn->bthp", Cc * cum.exp()[..., None], state)
            to_end = (cum[:, -1:] - cum).exp()
            state = (state * cum[:, -1].exp()[:, :, None, None]
                     + self.ein("bshn,bshp->bhpn", Bc * to_end[..., None], xc))
            ys.append(y)
        return torch.cat(ys, dim=1)

    def ssm(self, p, x):
        m = self.m
        B, S, D = x.shape
        d_in = m["ssm_expand"] * D
        H, G, N = d_in // m["ssm_head_dim"], m["ssm_ngroups"], m["ssm_state"]
        z = self.mm(x, p["in_z"])
        xs = F.silu(self.conv(self.mm(x, p["in_x"]), p["conv_x"]))
        Bm = F.silu(self.conv(self.mm(x, p["in_B"]), p["conv_B"]))
        Cm = F.silu(self.conv(self.mm(x, p["in_C"]), p["conv_C"]))
        dt = F.softplus(self.mm(x, p["in_dt"]) + p["dt_bias"])        # (B,S,H)
        xh = xs.view(B, S, H, m["ssm_head_dim"])
        dA = dt * -torch.exp(p["A_log"])
        y = self.ssd(xh * dt[..., None], dA, Bm.view(B, S, G, N), Cm.view(B, S, G, N))
        y = (y + xh * p["D_skip"][:, None]).reshape(B, S, d_in)
        return self.mm(self.rms(y * F.silu(z), p["gate_norm"]["scale"]), p["out"])

    # -- loss ----------------------------------------------------------------
    def _ce_block(self, h, w, t):
        logits = self.mm(h, w)
        return (torch.logsumexp(logits, dim=-1)
                - logits.gather(-1, t[:, None])[:, 0]).sum()

    def loss(self, params: Dict[str, torch.Tensor], tokens, targets) -> torch.Tensor:
        m = self.m
        tree = _tree(params)
        h = tree["embed"]["table"][tokens]
        h = families.load(m["family"]).body(self, tree, h)
        h = self.rms(h, tree["final_norm"]["scale"])
        w = tree["lm_head"]["w"] if "lm_head" in tree else tree["embed"]["table"].T
        h, t = h.reshape(-1, h.shape[-1]), targets.reshape(-1)
        rows = max(1, BLOCK_ELEMS // w.shape[1])
        total = sum(_ckpt(self._ce_block, h[i:i + rows], w, t[i:i + rows])
                    for i in range(0, h.shape[0], rows))
        return total / h.shape[0]

    # -- steps ---------------------------------------------------------------
    def run(self, leaves: Sequence[W.Leaf], seed: int, batches: List[Dict[str, torch.Tensor]],
            accum_steps: int, device, keep_params: bool = False) -> Dict:
        """Follows ``len(batches)`` optimizer steps from the seed's weights.
        Returns the steps' losses, each leaf's norm of the first clipped
        gradient and of the parameters' change over the steps (and, with
        ``keep_params``, the parameters)."""
        t = self.t
        b1, b2 = t["beta1"], t["beta2"]
        store = {n: dt for n, _, dt in leaves}
        params = {n: v.float().requires_grad_(True) for n, v in W.draw(leaves, seed, device)}
        names = list(params)
        mu = {n: torch.zeros_like(p) for n, p in params.items()}
        nu = {n: torch.zeros_like(p) for n, p in params.items()}
        losses, first = [], None
        for step, batch in enumerate(batches, start=1):
            rows = batch["tokens"].shape[0] // accum_steps
            acc = None
            lsum = 0.0
            for i in range(accum_steps):
                sl = slice(i * rows, (i + 1) * rows)
                loss = self.loss(params, batch["tokens"][sl], batch["targets"][sl])
                g = torch.autograd.grad(loss, [params[n] for n in names])
                acc = list(g) if acc is None else [a + b for a, b in zip(acc, g)]
                lsum += loss.item()
                del loss, g
            grads = [a / accum_steps for a in acc]
            del acc
            losses.append(lsum / accum_steps)
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            scale = torch.clamp(t["grad_clip"] / torch.clamp(norm, min=1e-9), max=1.0)
            grads = [g * scale for g in grads]
            if first is None:
                first = {n: g.norm().item() for n, g in zip(names, grads)}
            bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            with torch.no_grad():
                for n, g in zip(names, grads):
                    p = params[n]
                    mu[n] = b1 * mu[n] + (1 - b1) * g
                    nu[n] = b2 * nu[n] + (1 - b2) * g.square()
                    upd = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + EPS) + t["weight_decay"] * p
                    p.copy_((p - t["learning_rate"] * upd).to(store[n]).float())
            del grads
        del mu, nu
        with torch.no_grad():
            change = {n: (params[n] - w0.float()).norm().item()
                      for n, w0 in W.draw(leaves, seed, device)}
        out = {"losses": losses, "grad_norms": first, "change_norms": change}
        if keep_params:
            out["params"] = {n: p.detach() for n, p in params.items()}
        return out


def _tree(flat: Dict[str, torch.Tensor]) -> Dict:
    """``{"layers.0.attn.wq": t}`` as nested dicts."""
    out: Dict = {}
    for name, t in flat.items():
        node = out
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = t
    return out
