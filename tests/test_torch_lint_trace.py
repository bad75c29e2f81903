"""The port's trace linter (slice 15): the JAX package's AST linter with
its rules given torch meanings, and the no-torch boundary pass."""

from __future__ import annotations

import pytest

from ue22cs343bb1_openmp_assignment_tpu_torch.analysis import lint_trace


def _rules(src):
    return {f.rule for f in lint_trace.lint_source(src, "<case>")}


@pytest.mark.parametrize("src,rule", [
    ("def f(cfg, x):\n    if x > 0:\n        return x\n    return x\n",
     "traced-branch"),
    ("def f(cfg, x):\n    while x > 0:\n        x = x - 1\n    return x\n",
     "traced-branch"),
    ("def f(cfg, x):\n    assert x > 0\n    return x\n", "traced-branch"),
    ("def f(cfg, x):\n    return 1 if x > 0 else 0\n", "traced-branch"),
    ("def f(cfg, n):\n    for i in range(n):\n        pass\n",
     "traced-branch"),
    ("import torch\ndef f(cfg, x):\n    m = torch.where(x > 0, x, 0)\n"
     "    if m.any():\n        return m\n    return x\n", "traced-branch"),
    ("def f(cfg, x):\n    return x.item()\n", "host-sync"),
    ("def f(cfg, x):\n    return x.tolist()\n", "host-sync"),
    ("def f(cfg, x):\n    return x.cpu()\n", "host-sync"),
    ("def f(cfg, x):\n    return x.sum().numpy()\n", "host-sync"),
    ("def f(cfg, x):\n    return int(x)\n", "host-sync"),
    ("def f(cfg, x):\n    return bool(x.all())\n", "host-sync"),
    ("def f(cfg, x):\n    return float(x)\n", "host-sync"),
    ("def f(cfg, x):\n    return f'{x}'\n", "host-sync"),
    ("import numpy as np\ndef f(cfg, x):\n    return np.sum(x)\n",
     "host-call"),
    ("def f(cfg, x):\n    print(x)\n    return x\n", "host-call"),
    ("import torch\ndef f(cfg):\n    return torch.arange(4)\n",
     "dtype-drift"),
    ("import torch\ndef f(cfg, dev):\n"
     "    return torch.zeros((3,), device=dev)\n", "dtype-drift"),
    ("import torch\ndef f(cfg):\n    return torch.ones(3)\n", "dtype-drift"),
    ("import torch\ndef f(cfg):\n    return torch.empty(3)\n", "dtype-drift"),
    ("import torch\ndef f(cfg):\n    return torch.full((3,), 7)\n",
     "dtype-drift"),
    ("import random\n", "nondeterminism"),
    ("from secrets import token_bytes\n", "nondeterminism"),
    ("def f(cfg, x):\n    import time\n    return x + time.time()\n",
     "nondeterminism"),
    ("import numpy as np\ndef f(cfg, x):\n    return x + np.random.rand()\n",
     "nondeterminism"),
])
def test_linter_catches(src, rule):
    assert rule in _rules(src), f"linter missed {rule} in:\n{src}"


@pytest.mark.parametrize("src", [
    # host-side escape hatches
    'def f(cfg, x):\n    "Host-side check."\n    return int(x)\n',
    "def f(cfg, x):  # lint: host\n    return int(x)\n",
    "# lint: host\ndef f(cfg, x):\n    return bool(x.any())\n",
    # identity tests are host-decidable
    "def f(cfg, x, y=None):\n    if y is None:\n        y = x\n    return y\n",
    # static unrolling over containers of tensors is the idiom
    ("def f(cfg, xs):\n    acc = 0\n    for x in [xs, xs]:\n"
     "        acc = acc + x\n    return acc\n"),
    # static metadata kills taint
    "def f(cfg, x):\n    if x.ndim > 1:\n        return x\n    return x\n",
    "def f(cfg, x):\n    if x.shape[0] > 1:\n        return x\n    return x\n",
    ("def f(cfg, x):\n    if x.device.type == 'cuda':\n        return x\n"
     "    return x\n"),
    "def f(cfg, x):\n    for i in range(x.numel()):\n        pass\n",
    # reversed() of a tensor is a flip on the device, of a list a host walk
    "def f(cfg, xs, ys):\n    return list(zip(reversed(xs), reversed(ys)))\n",
    # scalar and container annotations are host values
    "def f(cfg, n: int, m: int | None, d: tuple):\n"
    "    if n and m is not None and d:\n        return n\n    return 0\n",
    # host queries of torch
    ("import torch\ndef f(cfg):\n    if torch.cuda.is_available():\n"
     "        return 1\n    return 0\n"),
    # explicit dtypes are the rule, not a finding
    ("import torch\ndef f(cfg):\n"
     "    return torch.arange(4, dtype=torch.int32)\n"),
    ("import torch\ndef f(cfg, dev):\n"
     "    return torch.full((3,), 7, dtype=torch.int32, device=dev)\n"),
    # *_like inherits its base dtype
    "import torch\ndef f(cfg, x):\n    return torch.zeros_like(x)\n",
])
def test_linter_stays_quiet(src):
    assert not _rules(src), f"false positive on:\n{src}"


def test_linter_nested_function_inherits_taint():
    src = ("def f(cfg, x):\n"
           "    def body(c):\n"
           "        if c > 0:\n"
           "            return c\n"
           "        return c\n"
           "    return body\n")
    hits = [f for f in lint_trace.lint_source(src, "<case>")
            if f.rule == "traced-branch"]
    assert hits and hits[0].func == "f.body"


def test_port_device_code_lints_clean():
    """The acceptance gate: the port's ops/ parallel/ models/ carry 0
    findings, and the wire layer and ops plane import no torch."""
    targets = {p.name for p in lint_trace.default_targets()}
    assert targets == {"ops", "parallel", "models"}
    findings = lint_trace.lint_paths() + lint_trace.lint_no_torch()
    assert not findings, "\n".join(f.render() for f in findings)


def test_no_torch_targets_are_the_wire_layer_and_ops_plane():
    assert [p.parent.name + "/" + p.name
            for p in lint_trace.no_torch_targets()] == [
        "daemon/server.py", "daemon/client.py", "obs/events.py",
        "obs/promexpo.py", "obs/burnrate.py", "obs/fleet.py"]


@pytest.mark.parametrize("src", [
    "import torch\n", "import torch.cuda as tc\n",
    "from torch import nn\n", "x = torch\n",
    "import importlib\nm = importlib.import_module('torch.nn')\n",
])
def test_no_torch_pass_catches(src):
    hits = lint_trace.lint_no_torch_source(src, "<case>")
    assert hits and all(f.rule == "no-torch" for f in hits)


def test_no_torch_pass_stays_quiet():
    src = "import json\nimport socket\nfrom . import protocol\n"
    assert not lint_trace.lint_no_torch_source(src, "<case>")


def test_finding_renders_like_the_jax_linter():
    f = lint_trace.lint_source("def f(cfg, x):\n    return x.item()\n",
                               "m.py")[0]
    assert f.render() == ("m.py:2:11: [host-sync] in `f`: .item() on a "
                          "tensor blocks on a device->host transfer")
    assert f.as_dict()["rule"] == "host-sync"
