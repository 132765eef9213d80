"""The lint lane over the port: ``tools/bpslint`` run over
``byteps_tpu_torch`` (and ``docs``, which it shares with the JAX package),
with the port's config, injector and health modules and the JAX
configuration's docs, blocking calls and callback names.  Every rule stays
enabled; the findings must be exactly the named exclusions below.

Run: ``python -m pytest tests/test_torch_lint.py``."""

import shutil
from pathlib import Path

import pytest

from tools.bpslint import core
from tools.bpslint.config import BpslintConfig, load_config

ROOT = Path(__file__).resolve().parent.parent

# (rule, path, message fragment) -> why the port cannot remove it
EXCLUSIONS = {
    ("env-knob", "docs/env.md", "documented knob BYTEPS_AOT_FULL"):
        "AOT warming is JAX-only (nothing in the port compiles ahead of "
        "time), and docs/env.md belongs to the JAX package, which keeps "
        "the row",
}


def _config():
    """The port's modules; the JAX configuration's docs, blocking calls
    and callback names (``[tool.bpslint]`` in pyproject.toml)."""
    base = load_config(ROOT)
    return BpslintConfig(
        paths=["byteps_tpu_torch", "docs"], package="byteps_tpu_torch",
        config_module="byteps_tpu_torch/common/config.py",
        env_doc=base.env_doc, metrics_doc=base.metrics_doc,
        injector_module="byteps_tpu_torch/fault/injector.py",
        health_module="byteps_tpu_torch/common/health.py",
        blocking_calls=base.blocking_calls,
        callback_names=base.callback_names)


def _excluded(f):
    return any(f.rule == rule and f.path == path and frag in f.message
               for rule, path, frag in EXCLUSIONS)


def test_port_lint_finds_only_the_named_exclusions():
    cfg = _config()
    assert cfg.enabled_rules() == BpslintConfig().enabled_rules()
    findings = core.run(ROOT, cfg)
    unexpected = [f for f in findings if not _excluded(f)]
    assert not unexpected, "\n".join(map(str, unexpected))
    # each exclusion still fires: a stale one must be taken out
    for key in EXCLUSIONS:
        rule, path, frag = key
        assert any(f.rule == rule and f.path == path and frag in f.message
                   for f in findings), key


def _tree_copy(tmp_path):
    """The port and docs under ``tmp_path`` (the config is passed in, so
    bpslint reads no ``pyproject.toml`` there)."""
    for d in ("byteps_tpu_torch", "docs"):
        shutil.copytree(ROOT / d, tmp_path / d,
                        ignore=shutil.ignore_patterns(
                            "__pycache__", "_build", "*.so"))
    return tmp_path


# one restored pragma of each rule: (file, the line it guards, the finding)
STRIPPED = [
    ("byteps_tpu_torch/fault/injector.py", '    "coordinator",',
     ("chaos-site", "'coordinator' is never woven")),
    ("byteps_tpu_torch/server/serve_host.py",
     'bind = os.environ.get("BYTEPS_SERVE_HOST_BIND"',
     ("env-knob", "BYTEPS_SERVE_HOST_BIND is read here")),
    ("byteps_tpu_torch/tools/weak_scaling.py",
     'slices = os.environ.get("BYTEPS_WS_PIN")',
     ("env-knob", "BYTEPS_WS_PIN")),
]


@pytest.mark.parametrize("path,guarded,finding", STRIPPED,
                         ids=["chaos-site", "env-knob", "tool-pin"])
def test_a_stripped_pragma_gives_its_finding_back(tmp_path, path, guarded,
                                                  finding):
    root = _tree_copy(tmp_path)
    src = (root / path).read_text().splitlines(keepends=True)
    at = next(i for i, line in enumerate(src) if guarded in line)
    assert "bpslint: ignore[" in src[at - 1]
    del src[at - 1]
    (root / path).write_text("".join(src))
    findings = [f for f in core.run(root, _config()) if not _excluded(f)]
    rule, frag = finding
    assert findings and all(f.rule == rule and f.path == path
                            and frag in f.message for f in findings), \
        "\n".join(map(str, findings))


def test_a_removed_fire_site_is_found(tmp_path):
    """Control for the repairs: without its ``dcn`` fires the port's
    injector names the site unwoven again."""
    root = _tree_copy(tmp_path)
    for path in ("byteps_tpu_torch/comm/collectives.py",
                 "byteps_tpu_torch/comm/compressed.py"):
        p = root / path
        p.write_text(p.read_text().replace('_fault.fire("dcn")', "pass"))
    findings = [f for f in core.run(root, _config()) if not _excluded(f)]
    assert [(f.rule, f.path) for f in findings] == [
        ("chaos-site", "byteps_tpu_torch/fault/injector.py")]
    assert "'dcn' is never woven" in findings[0].message
