"""The port's dcomlint (``repro_torch.lint``): a true positive, a true
negative and a suppression for each rule, the framework's mechanics, the
CLI's exit codes and JSON report, parity with ``repro.lint`` on the
reference's own determinism and family fixtures, and the meta-test that
the port's tree (``src/repro_torch``, ``chip_smoke.py``) lints clean.

Each fixture is the smallest program that shows (or lawfully avoids) one
rule's defect; the true negative beside each true positive pins the
rule's precision.
"""
import json
import os
import textwrap

import pytest

from repro_torch.lint import (REGISTRY, SCHEMA, check_file,
                              parse_suppressions, run_paths)
from repro_torch.lint.__main__ import main as lint_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# paths chosen so the package-scoped rules (F1/J2 serving, O1 obs and
# serving, K1 kernels) see the module they gate
SERVING = "src/repro_torch/serving/fixture.py"
OBS = "src/repro_torch/obs/fixture.py"
KERNELS = "src/repro_torch/kernels/fixture.py"
API = "src/repro_torch/models/api.py"
ANY = "src/repro_torch/tune/fixture.py"


def lint(src, path=ANY, select=None):
    """Lint a snippet → (active rule ids, suppressed rule ids)."""
    rules = [REGISTRY[r] for r in select] if select else None
    active, suppressed = check_file(path, rules, textwrap.dedent(src))
    return [f.rule for f in active], [f.rule for f in suppressed]


def test_registry_has_the_port_rules():
    assert set(REGISTRY) == {"D1", "D2", "D3", "F1", "J2", "O1", "K1"}
    for rule in REGISTRY.values():
        assert rule.doc(), rule.id
        assert rule.severity in ("error", "warning")


# ---------------------------------------------------------------- D1 ----

@pytest.mark.parametrize("src", [
    "seed = abs(hash(str(path))) % 2**31\n",
    'name = f"cache-{id(table)}.json"\n',
    "g = torch.manual_seed(id(obj))\n"])
def test_d1_flags_hash_and_id_into_a_sink(src):
    assert lint(src)[0] == ["D1"]


def test_d1_allows_crc32_and_identity_dict():
    assert lint("""\
        import zlib
        seed = zlib.crc32(str(path).encode()) % 2**31
        registry[id(obj)] = obj          # a host-lifetime identity key
    """)[0] == []


def test_d1_suppression():
    assert lint("h = hash(key)  # dcomlint: disable=D1\n") == ([], ["D1"])


# ---------------------------------------------------------------- D2 ----

@pytest.mark.parametrize("src", [
    "import time\nt0 = time.time()\n",
    "from time import time as now\nt0 = now()\n"])
def test_d2_flags_wall_clock(src):
    assert lint(src)[0] == ["D2"]


def test_d2_allows_perf_counter_and_monotonic():
    assert lint("""\
        import time
        t0 = time.perf_counter()
        t1 = time.monotonic()
    """)[0] == []


def test_d2_suppression_for_epoch_use():
    assert lint("""\
        import time
        # compared against mtimes, which are wall-clock
        now = time.time()  # dcomlint: disable=D2
    """) == ([], ["D2"])


# ---------------------------------------------------------------- D3 ----

def test_d3_flags_bare_write():
    assert lint("""\
        import json
        def save(path, obj):
            with open(path, "w") as f:
                json.dump(obj, f)
    """)[0] == ["D3"]


@pytest.mark.parametrize("src", ["""\
    import json, os
    def save(path, obj):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)
""", """\
    def load(path):
        with open(path) as f:
            return f.read()
    def load2(path):
        with open(path, "rb") as f:
            return f.read()
"""], ids=["tmp_replace", "reads"])
def test_d3_allows_atomic_writes_and_reads(src):
    assert lint(src)[0] == []


def test_d3_suppression():
    assert lint("""\
        def save(path, text):
            f = open(path, "w")  # dcomlint: disable=D3
            f.write(text)
    """) == ([], ["D3"])


# ---------------------------------------------------------------- F1 ----

@pytest.mark.parametrize("src,path", [("""\
    def _prefill_args(self, toks):
        if self.cfg.family == "vlm":
            return (toks, self._image_zeros())
        return (toks,)
""", SERVING), ("""\
    def admit(self, cfg):
        return _SPLICERS[cfg.family](self.cache)
""", API)], ids=["branch", "table"])
def test_f1_flags_family_dispatch(src, path):
    assert lint(src, path=path)[0] == ["F1"]


def test_f1_allows_registered_resolvers_asserts_and_other_modules():
    assert lint("""\
        def model_fns(cfg):
            return _FAMILY[cfg.family]
        def serving_family(eng, paged=False):
            key = "transformer-dkv" if eng.dkv_rank else eng.cfg.family
            return _REGISTRY[key](eng, paged=paged)
        def decomposed_fns(cfg):
            assert cfg.family == "dense", "dense family only"
    """, path=SERVING)[0] == []
    assert lint('wide = cfg.family in ("vlm", "audio")\n')[0] == []


def test_f1_suppression():
    assert lint('legacy = cfg.family == "audio"  # dcomlint: disable=F1\n',
                path=SERVING) == ([], ["F1"])


# ---------------------------------------------------------------- J2 ----

def test_j2_flags_syncs_in_serving():
    active, _ = lint("""\
        import torch
        def step(self, x):
            torch.cuda.synchronize()
            n = x.item()
            rows = x.tolist()
            return n, float(torch.sum(x)), x.cpu()
    """, path=SERVING)
    assert active == ["J2"] * 5


def test_j2_ignores_host_values_and_other_modules():
    assert lint("""\
        import numpy as np
        def emit(self, fold):
            return int(fold.sum()), np.asarray(self.host_tokens)
    """, path=SERVING)[0] == []
    assert lint("def measure(x):\n    return x.item()\n")[0] == []


def test_j2_suppression():
    assert lint("""\
        def sample(self, toks):
            return toks.numpy()  # dcomlint: disable=J2
    """, path=SERVING) == ([], ["J2"])


# ---------------------------------------------------------------- O1 ----

@pytest.mark.parametrize("src", ["import torch\n",
                                 "from torch.utils import data\n"])
def test_o1_flags_torch_in_obs(src):
    assert "O1" in lint(src, path=OBS)[0]


def test_o1_allows_host_only_obs():
    assert lint("import math\nfrom .registry import GLOBAL\n",
                path=OBS)[0] == []


@pytest.mark.parametrize("src", ["""\
    import torch
    def capture(self, g, body, x):
        with torch.cuda.graph(g):
            out = body(x)
            self.stats.captured += 1
        return out
""", """\
    def decode_block(self, feed):
        def body(tok):
            self.obs.tracer.span("step")
            return tok
        return self._run_block("k", body, feed)
    def _run_block(self, key, body, feed):
        return self.eng.graphs.run(key, body, feed, capture=True)
"""], ids=["with_graph", "body_to_graphs_run"])
def test_o1_flags_obs_in_captured_body(src):
    assert lint(src, path=SERVING)[0] == ["O1"]


def test_o1_allows_obs_outside_the_capture():
    assert lint("""\
        import torch
        from ..obs import record_compile
        def capture(self, g, body, x):
            with torch.cuda.graph(g):
                out = body(x)
            record_compile("cuda_graph", 1.0)
            self.stats.captures += 1
            return out
    """, path=SERVING)[0] == []


def test_o1_file_suppression():
    assert lint("# dcomlint: disable-file=O1\nimport torch\n",
                path=OBS) == ([], ["O1"])


# ---------------------------------------------------------------- K1 ----

_K1_OK = """\
    import torch
    def add(x, y):
        out = torch.empty_like(x)
        err = _lib().dcom_add(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"add kernel launch failed ({err})")
        add.launches += 1
        return out
    add.launches = 0
"""


def test_k1_allows_a_checked_counted_launch():
    assert lint(_K1_OK, path=KERNELS)[0] == []
    assert lint("""\
        def _launch(a, stream):
            if _lib().dcom_scale(a, stream.cuda_stream):
                raise RuntimeError("scale")
        def scale(a, stream):
            _launch(a, stream)
            scale.launches += 1
        scale.launches = 0
    """, path=KERNELS)[0] == []


@pytest.mark.parametrize("drop", ["check", "count"])
def test_k1_flags_an_unchecked_or_uncounted_launch(drop):
    src = _K1_OK
    if drop == "check":
        src = src.replace("if err:", "if False:")
    else:
        src = src.replace("add.launches += 1", "pass")
    assert lint(src, path=KERNELS)[0] == ["K1"]
    assert lint(src, path=ANY)[0] == []      # kernels/ only


def test_k1_ignores_library_queries():
    assert lint("""\
        def smem(lib, s):
            return lib.dcom_smem_bytes(s)
    """, path=KERNELS)[0] == []


def test_k1_suppression():
    src = _K1_OK.replace("add.launches += 1", "pass").replace(
        "out.data_ptr(),", "out.data_ptr(),  # dcomlint: disable=K1")
    assert lint(src, path=KERNELS) == ([], ["K1"])


# ------------------------------------------------------ framework -------

def test_syntax_error_becomes_e0_finding():
    assert lint("def broken(:\n")[0] == ["E0"]


def test_line_suppression_is_line_scoped():
    assert lint("""\
        h1 = hash(a)  # dcomlint: disable=D1
        h2 = hash(b)
    """) == (["D1"], ["D1"])


def test_disable_all_on_line():
    assert lint("h = hash(a)  # dcomlint: disable=all\n") == ([], ["D1"])


def test_parse_suppressions_shapes():
    per_line, per_file = parse_suppressions([
        "x = 1  # dcomlint: disable=D1,D2",
        "# dcomlint: disable-file=K1",
    ])
    assert per_line == {1: {"D1", "D2"}} and per_file == {"K1"}


def test_unknown_rule_id_raises():
    with pytest.raises(ValueError, match="unknown rule id"):
        run_paths([os.path.join(REPO, "src", "repro_torch", "lint")],
                  select=["P1"])


def test_select_filters_rules():
    src = "import time\nh = hash(time.time())\n"
    assert lint(src, select=["D1"])[0] == ["D1"]
    assert lint(src, select=["D2"])[0] == ["D2"]


# ------------------------------------------------------------ CLI ------

def _write(tmp_path, name, src):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return str(p)


def test_cli_exit_codes_and_json_report(tmp_path, capsys):
    bad = _write(tmp_path, "bad.py", "h = hash(x)\n")
    good = _write(tmp_path, "good.py", "y = 1\n")
    report_path = str(tmp_path / "report.json")
    assert lint_main([bad, "--json", report_path]) == 1
    report = json.loads(open(report_path).read())
    assert report["schema"] == SCHEMA == "repro_torch.lint/v1"
    assert report["ok"] is False and report["counts"] == {"D1": 1}
    assert report["findings"][0]["rule"] == "D1"
    assert lint_main([good, "--json", report_path]) == 0
    report = json.loads(open(report_path).read())
    assert report["ok"] is True and report["findings"] == []
    assert lint_main([bad, "--select", "D2"]) == 0
    assert lint_main([bad, "--select", "NOPE"]) == 2
    assert lint_main([str(tmp_path / "missing")]) == 2
    capsys.readouterr()


def test_cli_list_rules_and_suppression_count(tmp_path, capsys):
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in REGISTRY:
        assert rid in out
    p = _write(tmp_path, "sup.py", "h = hash(x)  # dcomlint: disable=D1\n")
    assert lint_main([p]) == 0
    assert "(1 suppressed)" in capsys.readouterr().out


# --------------------------------------------- parity with repro.lint --

#: the reference's own D1–D3 and F1 fixtures (``tests/test_lint.py``),
#: the F1 ones with the module they are linted as
_PARITY = [
    ("seed = abs(hash(str(path))) % 2**31\n", None),
    ('name = f"cache-{id(table)}.json"\n', None),
    ("import zlib\nseed = zlib.crc32(str(path).encode()) % 2**31\n"
     "registry[id(obj)] = obj\n", None),
    ("h = hash(key)  # dcomlint: disable=D1\n", None),
    ("import time\nt0 = time.time()\n", None),
    ("from time import time as now\nt0 = now()\n", None),
    ("import time\nt0 = time.perf_counter()\nt1 = time.monotonic()\n", None),
    ("import json\ndef save(path, obj):\n    with open(path, 'w') as f:\n"
     "        json.dump(obj, f)\n", None),
    ("import json, os\ndef save(path, obj):\n    tmp = path + '.tmp'\n"
     "    with open(tmp, 'w') as f:\n        json.dump(obj, f)\n"
     "    os.replace(tmp, path)\n", None),
    ("def load(path):\n    with open(path, 'rb') as f:\n"
     "        return f.read()\n", None),
    ("def _prefill_args(self, toks):\n    if self.cfg.family == 'vlm':\n"
     "        return (toks, self._image_zeros())\n    return (toks,)\n",
     "serving"),
    ("def admit(self, cfg):\n    return _SPLICERS[cfg.family](self.cache)\n",
     "api"),
    ("def model_fns(cfg):\n    return _FAMILY[cfg.family]\n"
     "def decomposed_fns(cfg):\n    assert cfg.family == 'dense'\n",
     "serving"),
    ('wide = cfg.family in ("vlm", "audio")\n', None),
    ('legacy = cfg.family == "audio"  # dcomlint: disable=F1\n', "serving"),
]


@pytest.mark.parametrize("src,where", _PARITY)
def test_parity_with_the_reference_on_its_fixtures(src, where):
    """The port's D1–D3 and F1 give the rule ids ``repro.lint``'s give on
    the reference's fixtures, each linted as the module of its own
    package (``repro/...`` against ``repro_torch/...``)."""
    from repro.lint import REGISTRY as JREG, check_file as jcheck
    paths = {None: ("src/repro/tune/x.py", ANY),
             "serving": ("src/repro/serving/x.py", SERVING),
             "api": ("src/repro/models/api.py", API)}[where]
    ids = ("D1", "D2", "D3", "F1")
    ref = jcheck(paths[0], [JREG[i] for i in ids], src)
    port = check_file(paths[1], [REGISTRY[i] for i in ids], src)
    assert [[f.rule for f in x] for x in port] == \
        [[f.rule for f in x] for x in ref]


# ------------------------------------------------------- meta-test -----

def test_port_tree_is_clean():
    """``python -m repro_torch.lint src/repro_torch chip_smoke.py`` exits
    0.  Every suppression is deliberate, so their count is pinned: the
    checkpoint's epoch-time cutoff (D2), two family guards that raise
    (F1), and the readbacks of the sampled tokens and of a decode
    block's output (J2, two findings a line)."""
    findings, suppressed, nfiles = run_paths(
        [os.path.join(REPO, "src", "repro_torch"),
         os.path.join(REPO, "chip_smoke.py")])
    assert findings == [], "\n".join(f.render() for f in findings)
    assert nfiles > 80
    assert sorted(f.rule for f in suppressed) == \
        ["D2", "F1", "F1", "J2", "J2", "J2", "J2"], \
        "\n".join(f.render() for f in suppressed)
