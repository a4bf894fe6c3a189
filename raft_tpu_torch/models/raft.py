"""RAFT model, port of ``raft_tpu/models/raft.py``.

``RAFT.forward(image1, image2, iters, flow_init=None, test_mode=True)``
returns ``(flow_low, flow_up)`` with images and flows NHWC, as the JAX
model does. Inside, the (B, C, H, W) tensors are channels-last in memory
(``torch.channels_last``, NHWC) from the images to the flow, as are the
conv weights (set at construction; ``.to(device)`` and ``load_state_dict``
keep it), so cuDNN's NHWC convolutions run with no layout conversion
around them: the lookup's (B, H, W, levels·K²) output and the flow enter
the update block as ``permute`` views, and ``delta`` and the upsampling
mask leave it as NHWC views, none of them copied. An encoder whose norm
normalises NCHW copies (instance, group) computes in NCHW instead
(``models.encoders.memory_format``). The scanned
refinement loop becomes a Python loop, and ``coords1.detach()`` plays the
part of ``stop_gradient`` (core/raft.py:123).

Test mode runs the update block's mask head in the last refinement step
alone, the one whose mask the convex upsampler reads (the JAX model
computes it in every step of its scan and keeps the last); the flow is
the same bits. Train mode (``test_mode=False``) stacks each iteration's
low-resolution flow (and, for the basic model, its upsampling mask) and
upsamples the stack once after the loop, as the JAX model does;
``train=True`` trains the batch norms unless ``freeze_bn``.
``raw_predictions=True`` returns the basic model's stack in the
upsampler's subpixel domain for the fused loss.

``alternate_corr=True`` takes the memory-efficient path: only the fmap2
pyramid is built, and each step computes its windows on the fly (K5, or
the plain ``alt_corr_lookup`` under ``corr_impl="gather"``).

``mixed_precision`` follows the JAX model's casts (``compute_dtype``
bf16): fp32 master weights, convs in bf16 and norms in fp32 (see
``models.layers``), the fmaps cast to fp32 for the correlation island,
``net``/``inp`` in bf16, the lookup's output and the flow cast to bf16 into
the update block and ``delta`` back to fp32; coords stay fp32 throughout.
The GRU tails run their kernels (K2/K4) in bf16; the lookup runs on the
fp32 volume, or a bf16 one with ``corr_dtype="bfloat16"``. No autocast and
no loss scaling, as in JAX.

``remat`` recomputes each refinement step in the backward
(``torch.utils.checkpoint``, non-reentrant): ``remat_policy="full"`` saves
nothing inside the step, ``"dots"`` saves the convolutions' and matmuls'
outputs (the JAX ``checkpoint_dots`` policy). ``dropout > 0`` drops encoder
channels in train mode, drawn from the ``generator`` passed to ``forward``.

The serving engine's two forwards share the refinement loop
(:meth:`RAFT._refine`) with ``forward``: ``forward_ragged`` runs a capacity
box of mixed request shapes with per-row valid extents (the masked
correlation of ``serving.ragged``), ``forward_cached`` encodes only the new
frame and takes the first frame's features from the caller.

``gma_heads=1`` builds GMA (``models.gma``): after the context split
``forward`` forms the attention ``A`` over the 1/8 grid once (K6), and
each step's update block aggregates the motion features over it (K7,
``update.GMAUpdateBlock``); ``_refine`` hands ``A`` to ``_step``, and a
RAFT step takes none. ``forward_ragged``, ``forward_cached`` and a
``spatial`` axis refuse GMA: the attention spans every position of the
whole image.

Under a ``spatial`` mesh axis (``models.layers.set_spatial``, which sets
:attr:`RAFT.spatial`) the images are this rank's band of rows: the convs
and norms exchange their halos and statistics with the other bands
(``parallel.halo``), fmap2 is gathered whole so the volume holds this
band's queries against every target (1/spatial of the whole volume a
rank), the coordinates are the whole image's, and the test-mode return is
this band's rows of ``(flow_low, flow_up)``. ``forward_ragged`` and
``forward_cached`` refuse it, as the JAX engine refuses ragged and cached
serving under a mesh.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.corr import (AlternateCorrBlock, build_corr_pyramid,
                                        corr_lookup)
from raft_tpu_torch.models.encoders import BasicEncoder, SmallEncoder
from raft_tpu_torch.models.gma import MAX_POS_SIZE, Attention
from raft_tpu_torch.models.layers import init_weights, set_compute_dtype
from raft_tpu_torch.models.update import (BasicUpdateBlock, GMAUpdateBlock,
                                          SmallUpdateBlock)
from raft_tpu_torch.ops.flow_ops import (convex_upsample,
                                         convex_upsample_batched_raw,
                                         initialize_flow, subpixel_to_standard,
                                         upflow8, upflow8_batched)
from raft_tpu_torch.parallel.halo import gather_rows


_DOTS = (torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the convolutions' and matmuls' outputs,
    recompute the rest (``jax.checkpoint_policies.checkpoint_dots``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


class RAFT(nn.Module):
    """Recurrent All-Pairs Field Transforms (core/raft.py:24).

    Weights are drawn from ``generator`` (a CPU ``torch.Generator``; seed 0
    when none is given) on the CPU; move the module with ``.to(device)``.
    """

    #: the ``spatial`` axis the images are a band of (None: whole images;
    #: ``models.layers.set_spatial``)
    spatial = None

    def __init__(self, config: RAFTConfig = RAFTConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        if cfg.small:
            self.fnet = SmallEncoder(cfg.fnet_dim, cfg.fnet_norm, cfg.dropout)
            self.cnet = SmallEncoder(cfg.cnet_dim, cfg.cnet_norm, cfg.dropout)
            self.update_block = SmallUpdateBlock(cfg.corr_planes,
                                                 cfg.hidden_dim)
        else:
            self.fnet = BasicEncoder(cfg.fnet_dim, cfg.fnet_norm, cfg.dropout)
            self.cnet = BasicEncoder(cfg.cnet_dim, cfg.cnet_norm, cfg.dropout)
            fused = cfg.gru_impl == "fused"
            if cfg.gma_heads:
                self.update_block = GMAUpdateBlock(
                    cfg.corr_planes, cfg.hidden_dim, fused, cfg.gma_heads)
                self.att = Attention(cfg.context_dim, cfg.gma_heads,
                                     cfg.context_dim, MAX_POS_SIZE)
            else:
                self.update_block = BasicUpdateBlock(
                    cfg.corr_planes, cfg.hidden_dim, fused=fused)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        if cfg.gma_heads:
            self.att.pos_emb.reset_parameters(generator)
        set_compute_dtype(self, cfg.compute_dtype)
        self.to(memory_format=torch.channels_last)
        for enc in (self.fnet, self.cnet):
            enc.to(memory_format=enc.memory_format)

    def _corr_setup(self, fmap1: torch.Tensor, fmap2: torch.Tensor
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
        """The ``corr_impl`` dispatch for an fp32 NHWC fmap pair: builds the
        correlation state once and returns ``lookup(coords) -> (B, H, W,
        levels·K²)`` for each refinement step (``raft.py:80-143`` in the
        JAX package); ``forward``, ``forward_ragged`` and
        ``forward_cached`` share it."""
        cfg = self.config
        r = cfg.corr_radius
        if self.spatial is not None:
            # the query-sharded volume: this band's queries, every target
            fmap2 = gather_rows(fmap2, self.spatial, dim=1)
        if cfg.alternate_corr:
            block = AlternateCorrBlock(fmap1, fmap2, cfg.corr_levels, r)
            if cfg.corr_impl == "gather":
                return block
            from raft_tpu_torch.kernels.corr_alt import alt_corr_lookup_cuda

            return lambda coords: alt_corr_lookup_cuda(
                block.fmap1, block.fmap2_pyramid, coords, r)
        pyramid = build_corr_pyramid(fmap1, fmap2, cfg.corr_levels)
        if cfg.corr_dtype == "bfloat16":
            pyramid = [v.to(torch.bfloat16) for v in pyramid]
        return lambda coords: corr_lookup(pyramid, coords, r, cfg.corr_impl)

    def _step(self, lookup, net, inp, coords0, coords1, attn=None,
              mask: bool = True):
        """One refinement step (the JAX model's scan body): lookup, update
        block in the compute dtype, ``delta`` added in fp32. Returns
        ``(net, coords1)`` and, for the basic model with ``mask``, the
        upsampling mask. ``attn``: GMA's attention, which its update block
        takes."""
        dt = self.config.compute_dtype
        corr = lookup(coords1)
        flow = coords1 - coords0
        args = (net, inp, corr.to(dt).permute(0, 3, 1, 2),
                flow.to(dt).permute(0, 3, 1, 2))
        if attn is not None:
            args += (attn,)
        net, up_mask, delta = self.update_block(*args, mask=mask)
        coords1 = coords1 + delta.permute(0, 2, 3, 1).float()
        return (net, coords1) if up_mask is None else (net, coords1, up_mask)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: int = 12, flow_init: Optional[torch.Tensor] = None,
                test_mode: bool = True, train: bool = False,
                freeze_bn: bool = False, raw_predictions: bool = False,
                generator: Optional[torch.Generator] = None,
                draw_rows: Optional[Tuple[int, int]] = None):
        """Estimate flow. Images: (B, H, W, 3) float in [0, 255] with
        H, W % 8 == 0 (pad with ``InputPadder``); ``flow_init``: (B, H/8,
        W/8, 2). Test mode returns ``(flow_low (B,H/8,W/8,2), flow_up
        (B,H,W,2))``; train mode the upsampled flow of every iteration,
        (iters, B, H, W, 2), or with ``raw_predictions`` (basic model) the
        subpixel-domain stack (iters, B, 2, 64, H/8·W/8). ``generator``
        draws the encoders' dropout masks when ``train`` and ``dropout >
        0`` (torch's default generator when it is None); with
        ``draw_rows=(start, global_batch)`` (a data-parallel rank's rows,
        ``split_encode`` on) each mask is the global batch's, cut to these
        rows."""
        cfg = self.config
        if not test_mode and raw_predictions and cfg.small:
            raise ValueError(
                "raw_predictions applies to the learned convex "
                "upsampler; the small model upsamples bilinearly")
        B, H, W, _ = image1.shape
        if H % 8 or W % 8:
            raise ValueError(f"image size {H}x{W}: pad inputs to a multiple "
                             "of 8 with InputPadder first")
        if cfg.gma_heads and self.spatial is not None:
            raise ValueError("GMA under a 'spatial' mesh axis: its attention "
                             "spans every band's positions; run it on whole "
                             "images")

        # normalize to [-1, 1] (core/raft.py:89-90), then (B, 3, H, W)
        # views of the NHWC images: channels-last
        x1 = (2.0 * (image1.float() / 255.0) - 1.0).permute(0, 3, 1, 2)
        x2 = (2.0 * (image2.float() / 255.0) - 1.0).permute(0, 3, 1, 2)

        if draw_rows is not None and not cfg.split_encode:
            raise ValueError("draw_rows needs split_encode: the batch-concat "
                             "encode would draw one mask over both frames")
        if cfg.split_encode:
            fmap1 = self.fnet(x1, train, freeze_bn, generator, draw_rows)
            fmap2 = self.fnet(x2, train, freeze_bn, generator, draw_rows)
        else:
            fmaps = self.fnet(torch.cat([x1, x2], 0), train, freeze_bn,
                              generator)
            fmap1, fmap2 = fmaps[:B], fmaps[B:]
        # the fp32 island for the correlation (raft.py:263-264 in JAX)
        lookup = self._corr_setup(fmap1.float().permute(0, 2, 3, 1),
                                  fmap2.float().permute(0, 2, 3, 1))

        # context network (core/raft.py:110-114)
        net, inp = self._encode_context(
            self.cnet(x1, train, freeze_bn, generator, draw_rows))
        # GMA's attention over the context features, once a pair
        attn = self.att(inp) if cfg.gma_heads else None
        return self._refine(lookup, net, inp, B, H, W, iters, flow_init,
                            test_mode, raw_predictions, image1.device, attn)

    def _refine(self, lookup, net, inp, B: int, H: int, W: int, iters: int,
                flow_init: Optional[torch.Tensor], test_mode: bool,
                raw_predictions: bool, device, attn=None):
        """The refinement recurrence and the upsampling tail, from the
        lookup and the context split to the mode's return values (the JAX
        model's ``_refine``, ``raft.py:145``), shared by ``forward``,
        ``forward_ragged`` and ``forward_cached``; ``attn`` is GMA's
        attention (None for RAFT)."""
        cfg = self.config
        sp = self.spatial
        row0 = 0 if sp is None else sp.band(H // 8)[0]
        coords0, coords1 = initialize_flow(B, H // 8, W // 8, device, row0)
        if flow_init is not None:
            coords1 = coords1 + flow_init
        step = functools.partial(self._step, lookup, attn=attn)
        if cfg.remat and torch.is_grad_enabled():
            kw = {}
            if cfg.remat_policy == "dots":
                kw["context_fn"] = functools.partial(
                    create_selective_checkpoint_contexts, _save_dots)
            step = functools.partial(checkpoint, step, use_reentrant=False,
                                     **kw)
        up_mask = None
        flows, masks = [], []
        for i in range(iters):
            # stop_gradient on the coordinate chain (core/raft.py:123); test
            # mode reads the last step's mask alone, so only it runs the head
            out = step(net, inp, coords0, coords1.detach().contiguous(),
                       mask=not test_mode or i == iters - 1)
            net, coords1 = out[:2]
            if not test_mode:
                flows.append(coords1 - coords0)
                if not cfg.small:
                    masks.append(out[2].permute(0, 2, 3, 1))
            elif len(out) > 2:
                up_mask = out[2]

        if test_mode:
            flow_lr = coords1 - coords0
            if cfg.small:
                return flow_lr, upflow8(flow_lr, sp)
            return flow_lr, convex_upsample(flow_lr,
                                            up_mask.permute(0, 2, 3, 1), sp)
        flows = torch.stack(flows)
        if cfg.small:
            return upflow8_batched(flows, sp)
        up = convex_upsample_batched_raw(flows, torch.stack(masks), sp)
        if raw_predictions:
            return up
        return subpixel_to_standard(up, H // 8, W // 8)

    def _encode_context(self, cnet: torch.Tensor):
        """The context split (core/raft.py:110-114): ``(net, inp)`` in the
        compute dtype from the context encoder's (B, C, H, W) output."""
        cfg = self.config
        dt = cfg.compute_dtype
        net = torch.tanh(cnet[:, :cfg.hidden_dim]).to(dt)
        inp = torch.relu(cnet[:, cfg.hidden_dim:]).to(dt)
        return net, inp

    def _whole_images(self, name: str) -> None:
        if self.config.gma_heads:
            raise ValueError(f"{name} with GMA (gma_heads=1): ragged and "
                             "feature-cache serving are built for RAFT; "
                             "serve GMA through the plain buckets")
        if self.spatial is not None:
            raise ValueError(f"{name} under a 'spatial' mesh axis: ragged "
                             "and feature-cache serving take whole images, "
                             "as the JAX engine refuses them under a mesh")

    def forward_ragged(self, image1: torch.Tensor, image2: torch.Tensor,
                       valid_h8: torch.Tensor, valid_w8: torch.Tensor,
                       flow_init: Optional[torch.Tensor] = None,
                       iters: int = 12):
        """Ragged serving: one program for mixed spatial shapes.

        ``image1``/``image2``: (B, Hcap, Wcap, 3) in [0, 255], a capacity
        box holding requests of different sizes (each row edge-padded to its
        own ÷8 alignment, then zero-filled). ``valid_h8``/``valid_w8``: (B,)
        int32 tensors, each row's valid extent at 1/8 resolution (0 for a
        fill row). The encoders run over the whole box; both fmaps are then
        masked in fp32 past each row's extent
        (``serving.ragged.mask_features``), so each row's correlation volume
        is its own smaller volume zero-embedded in the box. The extents are
        tensors, never Python ints, so a captured graph serves every mix.

        Returns the test-mode ``(flow_low, flow_up)`` at the box geometry;
        the serving layer crops each row. A full-extent row is bitwise what
        ``forward`` computes on the same padded batch.
        """
        from raft_tpu_torch.serving.ragged import mask_features

        self._whole_images("forward_ragged")
        B, H, W, _ = image1.shape
        if H % 8 or W % 8:
            raise ValueError(f"capacity box {H}x{W}: boxes are ÷8-aligned")
        x1 = (2.0 * (image1.float() / 255.0) - 1.0).permute(0, 3, 1, 2)
        x2 = (2.0 * (image2.float() / 255.0) - 1.0).permute(0, 3, 1, 2)
        fmaps = self.fnet(torch.cat([x1, x2], 0))
        fmap1 = mask_features(fmaps[:B].float().permute(0, 2, 3, 1),
                              valid_h8, valid_w8)
        fmap2 = mask_features(fmaps[B:].float().permute(0, 2, 3, 1),
                              valid_h8, valid_w8)
        lookup = self._corr_setup(fmap1, fmap2)
        net, inp = self._encode_context(self.cnet(x1))
        return self._refine(lookup, net, inp, B, H, W, iters, flow_init,
                            True, False, image1.device)

    def forward_cached(self, image2: torch.Tensor, fmap1: torch.Tensor,
                       cnet1: torch.Tensor, flow_init: torch.Tensor,
                       iters: int = 12):
        """Cross-frame cached serving: encode only the new frame.

        For consecutive video pairs the previous dispatch already encoded
        this pair's first frame: its ``fmap2`` and a speculative context
        encoding are this pair's ``fmap1`` and context. ``image2``: (B, H,
        W, 3) in [0, 255], the new frame. ``fmap1``: (B, H/8, W/8,
        fnet_dim) fp32, the previous call's ``fmap2``. ``cnet1``: (B, H/8,
        W/8, cnet_dim) fp32, the previous call's ``cnet2``; it is cast back
        to the encoder's dtype before the tanh/relu split, so the split sees
        the bits ``forward`` would. ``flow_init``: (B, H/8, W/8, 2).

        Returns ``(flow_low, flow_up, fmap2, cnet2)``, the last two NHWC
        fp32. A zeroed fmap1/cnet1 row is the prime form of a cold start:
        its flow is meaningless, its cache outputs are this frame's
        features.
        """
        self._whole_images("forward_cached")
        B, H, W, _ = image2.shape
        if H % 8 or W % 8:
            raise ValueError(f"image size {H}x{W}: pad inputs to a multiple "
                             "of 8 with InputPadder first")
        x2 = (2.0 * (image2.float() / 255.0) - 1.0).permute(0, 3, 1, 2)
        fmap2 = self.fnet(x2).float().permute(0, 2, 3, 1)
        # speculative context for the next pair, whose first frame this is
        cnet2 = self.cnet(x2)
        lookup = self._corr_setup(fmap1.float(), fmap2)
        cnet1 = cnet1.to(cnet2.dtype).permute(0, 3, 1, 2)
        net, inp = self._encode_context(cnet1)
        flow_low, flow_up = self._refine(lookup, net, inp, B, H, W, iters,
                                         flow_init, True, False,
                                         image2.device)
        return (flow_low, flow_up, fmap2.contiguous(),
                cnet2.float().permute(0, 2, 3, 1).contiguous())
