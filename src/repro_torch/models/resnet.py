"""The paper's evaluation model: ResNet9 plain-CNN (CIFAR10), W2A2 by
default, runnable end to end through the quantized serial pipeline.

Counterpart of ``repro/models/resnet.py``. Parameters are a plain numpy
dict — the same structure the reference's ``resnet9_graph`` takes, so one
set of float weights feeds both packages. Random weights come from
``np.random.default_rng(seed)`` (the reference draws from ``jax.random``,
so the two inits differ for one seed; tests hand the same numpy dict to
both).

* :func:`resnet9_graph` + :func:`resnet9_compile` — the deployment path
  through the graph compiler (conv1–conv8 on the packed conv kernel);
* :func:`resnet9_pack` + :func:`resnet9_forward_packed` — the hand-written
  deployment path: one calibration and weight packing, then conv1–conv8
  through :func:`~repro_torch.kernels.ops.serial_conv2d_packed_op` (K2,
  each at the tuner's tile for its shape; K1 packs the codes), chained in
  the packed format, pool stages hopping through integer codes;
* :func:`resnet9_forward` — the reference quantized path through the plain
  integer :func:`~repro_torch.core.bitserial.serial_conv2d`, weights
  quantized once by :func:`resnet9_quantize_weights`;
* :func:`resnet9_forward_float` — the float32 forward;
* :func:`resnet9_cost_layers` — the runnable model's geometry as cost-model
  layers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.compiler.ir import Graph, Node
from repro_torch.core.bitserial import SerialSpec, plan_spec, serial_conv2d
from repro_torch.core.pipeline_modules import host_conv2d, maxpool_relu, relu
from repro_torch.core.quant import (QuantSpec, init_alpha, pack_conv_weights,
                                    quantize_int)

__all__ = ["ResNet9Config", "resnet9_init", "resnet9_graph", "resnet9_compile",
           "resnet9_quantize_weights", "resnet9_forward", "resnet9_pack",
           "resnet9_forward_packed", "resnet9_forward_float",
           "resnet9_cost_layers"]


@dataclasses.dataclass(frozen=True)
class ResNet9Config:
    num_classes: int = 10
    a_bits: int = 2
    w_bits: int = 2
    radix_bits: int = 7
    # (name, c_in, c_out, stride, pool_after)
    layers = (
        ("conv1", 64, 64, 1, False),
        ("conv2", 64, 64, 1, False),
        ("conv3", 64, 128, 2, False),
        ("conv4", 128, 128, 1, True),
        ("conv5", 128, 256, 2, False),
        ("conv6", 256, 256, 1, True),
        ("conv7", 256, 512, 2, False),
        ("conv8", 512, 512, 1, False),
    )


def resnet9_init(seed: int = 0,
                 cfg: ResNet9Config = ResNet9Config()) -> Dict:
    """Random float params (numpy float32) with the reference's shapes and
    scales: conv0 N(0, 0.1²), conv_i N(0, 1/(9 c_in)), unit scales, zero
    biases, fc N(0, 0.05²)."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    p = {"conv0": {"w": normal((3, 3, 3, 64), 0.1)}}
    for name, ci, co, _, _ in cfg.layers:
        p[name] = {"w": normal((3, 3, ci, co), 1.0 / np.sqrt(9 * ci)),
                   "scale": np.ones((co,), np.float32),
                   "bias": np.zeros((co,), np.float32)}
    p["fc"] = {"w": normal((cfg.layers[-1][2], cfg.num_classes), 0.05)}
    return p


def resnet9_graph(params: Dict, cfg: ResNet9Config = ResNet9Config(), *,
                  input_hw: int = 32) -> Graph:
    """ResNet9 as a compiler IR graph: conv0 and fc marked ``host=True``
    (full precision, paper §4.1), hidden convs with explicit scale/bias
    initializer slots."""
    inits = {"conv0.w": np.asarray(params["conv0"]["w"]),
             "fc.w": np.asarray(params["fc"]["w"])}
    nodes = [
        Node("conv0", "conv2d", ["images", "conv0.w"], "conv0.y",
             {"stride": 1, "padding": 1, "host": True}),
        Node("conv0.relu", "relu", ["conv0.y"], "conv0.out"),
    ]
    x = "conv0.out"
    for name, ci, co, stride, pool in cfg.layers:
        inits[f"{name}.w"] = np.asarray(params[name]["w"])
        inits[f"{name}.scale"] = np.asarray(params[name]["scale"])
        inits[f"{name}.bias"] = np.asarray(params[name]["bias"])
        nodes.append(Node(name, "conv2d",
                          [x, f"{name}.w", f"{name}.scale", f"{name}.bias"],
                          f"{name}.y", {"stride": stride, "padding": 1}))
        nodes.append(Node(f"{name}.relu", "relu", [f"{name}.y"],
                          f"{name}.r"))
        x = f"{name}.r"
        if pool:
            nodes.append(Node(f"{name}.pool", "maxpool", [x],
                              f"{name}.p", {"window": 2}))
            x = f"{name}.p"
    nodes.append(Node("gap", "global_avg_pool", [x], "pooled"))
    nodes.append(Node("fc", "gemm", ["pooled", "fc.w"], "logits",
                      {"host": True}))
    g = Graph(name="resnet9_cifar10",
              inputs={"images": (None, input_hw, input_hw, 3)},
              outputs=["logits"], nodes=nodes, initializers=inits)
    g.validate()
    return g


def resnet9_compile(params: Dict, calib_images,
                    cfg: ResNet9Config = ResNet9Config(), *, device=None,
                    per_layer=None, input_hw: int = 32):
    """Compile ResNet9 through the graph compiler onto ``device`` (default:
    the card)."""
    from repro_torch.compiler.lower import compile_graph
    from repro_torch.models.layers import QuantPolicy
    policy = QuantPolicy(mode="serial", w_bits=cfg.w_bits, a_bits=cfg.a_bits,
                         radix_bits=cfg.radix_bits)
    return compile_graph(resnet9_graph(params, cfg, input_hw=input_hw),
                         calib_images, policy=policy, per_layer=per_layer,
                         device=device)


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def resnet9_quantize_weights(params: Dict,
                             cfg: ResNet9Config = ResNet9Config(), *,
                             device=None) -> Dict:
    """One-time weight calibration and quantization for the serial path:
    ``{layer: {"wq": int codes (FH, FW, Ci, Co), "alpha_w": (1, 1, 1,
    Co)}}`` on ``device`` (default: the CPU), computed once instead of in
    every forward."""
    wspec = QuantSpec(cfg.w_bits, True, per_channel=True)
    out = {}
    for name, ci, co, stride, pool in cfg.layers:
        w = _t(params[name]["w"], device)
        aw = init_alpha(w, wspec, axis=(0, 1, 2))
        out[name] = {"wq": quantize_int(w, aw, wspec), "alpha_w": aw}
    return out


def resnet9_forward(params: Dict, images: torch.Tensor,
                    cfg: ResNet9Config = ResNet9Config(), *,
                    qweights: Optional[Dict] = None,
                    _record_act_alphas: Optional[Dict] = None
                    ) -> torch.Tensor:
    """Quantized reference forward: conv0 (host, float) → 8 serial-conv
    stages on the plain integer path, each activation quantized with its
    own batch's step size → global pool → fc (host, float). With
    ``qweights`` (:func:`resnet9_quantize_weights`) the weights are not
    quantized again."""
    dev = images.device
    spec = SerialSpec(cfg.a_bits, cfg.w_bits, True, True, cfg.radix_bits)
    aspec = QuantSpec(cfg.a_bits, True)
    if qweights is None:
        qweights = resnet9_quantize_weights(params, cfg, device=dev)
    x = relu(host_conv2d(images, _t(params["conv0"]["w"], dev), 1, 1))
    for name, ci, co, stride, pool in cfg.layers:
        wq, aw = qweights[name]["wq"], qweights[name]["alpha_w"]
        ax = init_alpha(x, aspec)
        if _record_act_alphas is not None:
            _record_act_alphas[name] = ax
        xq = quantize_int(x, ax, aspec)
        acc = serial_conv2d(xq, wq, spec, stride=stride, padding=1)
        x = (acc.to(torch.float32)
             * (ax * aw.reshape(1, 1, 1, co) * _t(params[name]["scale"], dev))
             + _t(params[name]["bias"], dev))
        x = maxpool_relu(x, 2, with_relu=True) if pool else relu(x)
    x = torch.mean(x, dim=(1, 2))
    return x @ _t(params["fc"]["w"], dev)


def resnet9_pack(params: Dict, calib_images: torch.Tensor,
                 cfg: ResNet9Config = ResNet9Config()) -> Dict:
    """One-time deployment packing, on ``calib_images``' device: the
    quantized forward replayed on the calibration batch records each
    stage's activation step; every hidden conv is exported as packed
    planes (w_bits, 3, 3, ceil(Ci/32), Co) with the dequant scaler folded
    per output channel. The result feeds :func:`resnet9_forward_packed`."""
    dev = calib_images.device
    qweights = resnet9_quantize_weights(params, cfg, device=dev)
    act_alphas: Dict = {}
    resnet9_forward(params, calib_images, cfg, qweights=qweights,
                    _record_act_alphas=act_alphas)
    wspec = QuantSpec(cfg.w_bits, True, per_channel=True)
    packed: Dict = {"conv0": {"w": _t(params["conv0"]["w"], dev)},
                    "fc": {"w": _t(params["fc"]["w"], dev)}, "layers": {}}
    for name, ci, co, stride, pool in cfg.layers:
        aw = qweights[name]["alpha_w"]
        qw = pack_conv_weights(_t(params[name]["w"], dev), wspec, aw)
        ax = act_alphas[name]
        packed["layers"][name] = {
            "w_packed": qw.packed,
            # the scaler RAM: act step x weight step x the BN scale
            "scale": (ax * aw.reshape(1, 1, 1, co)
                      * _t(params[name]["scale"], dev)).reshape(co),
            "bias": _t(params[name]["bias"], dev),
            "act_alpha": ax,
        }
    return packed


def resnet9_forward_packed(packed: Dict, images: torch.Tensor,
                           cfg: ResNet9Config = ResNet9Config()
                           ) -> torch.Tensor:
    """Deployment forward: conv1–conv8 on K2, each at the tuner's tile for
    its shape (:func:`~repro_torch.kernels.ops.serial_conv2d_packed_op`
    given none), on the card for a CUDA ``images`` and on the plain
    versions on the CPU. Activations stay packed between stages (the fused
    requant-pack epilogue feeds the next); a pool stage emits integer
    codes, pools them (max commutes with the monotone quantizer) and packs
    them again (K1). Equals :func:`resnet9_forward` given the calibration
    batch's step sizes."""
    from repro_torch.kernels.ops import (pack_activations,
                                         serial_conv2d_packed_op)
    spec = plan_spec(SerialSpec(cfg.a_bits, cfg.w_bits, True, True,
                                cfg.radix_bits))
    aspec = QuantSpec(cfg.a_bits, True)
    layers = cfg.layers
    x = relu(host_conv2d(images, packed["conv0"]["w"], 1, 1))
    xp = pack_activations(quantize_int(
        x, packed["layers"][layers[0][0]]["act_alpha"], aspec), cfg.a_bits)
    for i, (name, ci, co, stride, pool) in enumerate(layers):
        lp = packed["layers"][name]
        common = dict(spec=spec, ci=ci, stride=stride, padding=1, relu=True)
        if i == len(layers) - 1:
            x = serial_conv2d_packed_op(xp, lp["w_packed"], lp["scale"],
                                        lp["bias"], **common)
            if pool:
                x = maxpool_relu(x, 2, with_relu=True)
            break
        nxt = packed["layers"][layers[i + 1][0]]
        if pool:
            codes = serial_conv2d_packed_op(
                xp, lp["w_packed"], lp["scale"], lp["bias"], requant=aspec,
                requant_scale=nxt["act_alpha"], **common)
            xp = pack_activations(maxpool_relu(codes.to(torch.int32), 2,
                                               with_relu=True), cfg.a_bits)
        else:
            xp = serial_conv2d_packed_op(
                xp, lp["w_packed"], lp["scale"], lp["bias"], requant=aspec,
                requant_scale=nxt["act_alpha"], emit_packed=True, **common)
    x = torch.mean(x, dim=(1, 2))
    return x @ packed["fc"]["w"]


def resnet9_forward_float(params: Dict, images: torch.Tensor,
                          cfg: ResNet9Config = ResNet9Config()) -> torch.Tensor:
    """FP32 reference forward (the 'Plain-CNN' rows of the paper's Table 2)."""
    dev = images.device
    x = relu(host_conv2d(images, _t(params["conv0"]["w"], dev), 1, 1))
    for name, ci, co, stride, pool in cfg.layers:
        x = host_conv2d(x, _t(params[name]["w"], dev), stride, 1)
        x = x * _t(params[name]["scale"], dev) + _t(params[name]["bias"], dev)
        x = maxpool_relu(x, 2, with_relu=True) if pool else relu(x)
    x = torch.mean(x, dim=(1, 2))
    return x @ _t(params["fc"]["w"], dev)


def resnet9_cost_layers(cfg: ResNet9Config = ResNet9Config()):
    """The runnable model's geometry as cost-model layers (pool stages
    shrink the late maps, unlike ``cost_model.RESNET9_CIFAR10``, the
    paper's Table 3 print): the hand-written codegen path a compiled
    Program's command stream is checked against."""
    from repro_torch.core.cost_model import ConvLayer, LinearLayer
    layers = [ConvLayer("conv0", 3, 64, 32, 32, on_host=True)]
    h = 32
    for name, ci, co, stride, pool in cfg.layers:
        layers.append(ConvLayer(name, ci, co, h, h, stride=stride))
        h = (h - 1) // stride + 1
        if pool:
            h //= 2
    layers.append(LinearLayer("fc", cfg.layers[-1][2], cfg.num_classes,
                              on_host=True))
    return layers
