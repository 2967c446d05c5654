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
* :func:`resnet9_forward` — the reference quantized path through the plain
  integer :func:`~repro_torch.core.bitserial.serial_conv2d`;
* :func:`resnet9_forward_float` — the float32 forward.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.compiler.ir import Graph, Node
from repro_torch.core.bitserial import SerialSpec, serial_conv2d
from repro_torch.core.pipeline_modules import host_conv2d, maxpool_relu, relu
from repro_torch.core.quant import QuantSpec, init_alpha, quantize_int

__all__ = ["ResNet9Config", "resnet9_init", "resnet9_graph", "resnet9_compile",
           "resnet9_forward", "resnet9_forward_float"]


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


def resnet9_forward(params: Dict, images: torch.Tensor,
                    cfg: ResNet9Config = ResNet9Config()) -> torch.Tensor:
    """Quantized reference forward: conv0 (host, float) → 8 serial-conv
    stages on the plain integer path, each activation quantized with its
    own batch's step size → global pool → fc (host, float)."""
    dev = images.device
    spec = SerialSpec(cfg.a_bits, cfg.w_bits, True, True, cfg.radix_bits)
    wspec = QuantSpec(cfg.w_bits, True, per_channel=True)
    aspec = QuantSpec(cfg.a_bits, True)
    x = relu(host_conv2d(images, _t(params["conv0"]["w"], dev), 1, 1))
    for name, ci, co, stride, pool in cfg.layers:
        w = _t(params[name]["w"], dev)
        aw = init_alpha(w, wspec, axis=(0, 1, 2))
        wq = quantize_int(w, aw, wspec)
        ax = init_alpha(x, aspec)
        xq = quantize_int(x, ax, aspec)
        acc = serial_conv2d(xq, wq, spec, stride=stride, padding=1)
        x = (acc.to(torch.float32)
             * (ax * aw.reshape(1, 1, 1, co) * _t(params[name]["scale"], dev))
             + _t(params[name]["bias"], dev))
        x = maxpool_relu(x, 2, with_relu=True) if pool else relu(x)
    x = torch.mean(x, dim=(1, 2))
    return x @ _t(params["fc"]["w"], dev)


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
