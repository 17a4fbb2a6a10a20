"""The serve CLI takes the reference's command lines.

Each command line of ``repro.launch.serve`` runs through both CLIs up to
the serving engine's construction: the reference's ``main()`` (it reads
``sys.argv``) with its ``DecomposeEngine`` and ``Engine`` patched from
here to capture what it builds, and the port's ``main(argv)`` (with
``--reduced --device cpu``: the reference always serves a reduced
config, on the host here) patched the same way.  Every field of the two
``EngineConfig``s must be equal, and so must the engine settings both
pass to ``Engine``.  ``--backend`` and ``--expansion`` are given
explicitly: their defaults differ by design (the port's ``cuda`` and
f = 16 against the reference's ``reference`` and f = 8).
"""
import dataclasses
import sys

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: test workers share the host's cores, and an
# oversubscribed OpenMP pool turns each tiny op into a wait on its
# barrier (a [8, 128] @ [128, 128] product: ~17 ms against ~5 us)
torch.set_num_threads(1)

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

EXPLICIT = ["--backend", "reference", "--expansion", "8"]
LINES = {
    "family-ssm": ["--family", "ssm"],
    "family-moe-async": ["--family", "moe", "--prefill-async",
                         "--ready-order", "deterministic"],
    "paged": ["--arch", "llama2-7b", "--decompose-kv-rank", "8",
              "--dkv-tail", "4", "--paged", "--pages", "64",
              "--page-size", "8", "--prefix-cache", "4"],
    "defaults-dkv": ["--family", "dense", "--decompose-kv-rank", "8"],
    "mesh-none-sched": ["--arch", "gemma-2b", "--decompose-kv-rank", "6",
                        "--mesh", "none", "--decode-block", "4",
                        "--sched-bucket", "8", "--admit-every", "2",
                        "--max-admit", "3", "--eos-id", "7", "--slots", "2",
                        "--max-len", "48", "--dkv-exact"],
    "gang": ["--arch", "zamba2-1.2b", "--admission", "gang"],
}
ENGINE_KW = ("slots", "max_len", "paged", "eos_id", "admission",
             "prefill_async", "ready_order")


class _Stop(Exception):
    pass


def _capture(monkeypatch, mod):
    """Patch ``mod``'s DecomposeEngine and Engine: record the config and
    the engine's settings, and stop at the engine's construction."""
    got = {}
    real = mod.DecomposeEngine

    def dengine(cfg, *a, **kw):
        got["config"] = cfg
        return real(cfg, *a, **kw)

    def engine(cfg, params, **kw):
        got["arch"] = cfg.name
        got["engine"] = {k: kw.get(k) for k in ENGINE_KW}
        raise _Stop

    monkeypatch.setattr(mod, "DecomposeEngine", dengine)
    monkeypatch.setattr(mod, "Engine", engine)
    return got


def _reference(monkeypatch, line):
    got = _capture(monkeypatch, jserve)
    monkeypatch.setattr(sys, "argv", ["serve"] + line)
    with pytest.raises(_Stop):
        jserve.main()
    return got


def _port(monkeypatch, line):
    got = _capture(monkeypatch, tserve)
    with pytest.raises(_Stop):
        tserve.main(line + ["--reduced", "--device", "cpu"])
    return got


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", sorted(LINES))
def test_reference_command_line_gives_the_reference_settings(monkeypatch,
                                                             name):
    line = LINES[name] + EXPLICIT
    want = _reference(monkeypatch, line)
    got = _port(monkeypatch, line)
    assert got["arch"] == want["arch"]
    assert _fields(got["config"]) == _fields(want["config"])
    assert got["engine"] == want["engine"]


def test_port_names_are_aliases(monkeypatch):
    """``--kv-page``/``--kv-prefix-cache`` set what ``--page-size``/
    ``--prefix-cache`` set."""
    base = ["--arch", "llama2-7b", "--decompose-kv-rank", "8", "--paged"]
    a = _port(monkeypatch, base + ["--kv-page", "8", "--kv-prefix-cache",
                                   "4"])
    b = _port(monkeypatch, base + ["--page-size", "8", "--prefix-cache",
                                   "4"])
    assert _fields(a["config"]) == _fields(b["config"])
    assert (a["config"].kv_page, a["config"].kv_prefix_cache) == (8, 4)


def test_family_must_match_the_arch(monkeypatch, capsys):
    line = ["--family", "ssm", "--arch", "llama2-7b"]
    monkeypatch.setattr(sys, "argv", ["serve"] + line)
    with pytest.raises(SystemExit):
        jserve.main()
    with pytest.raises(SystemExit):
        tserve.main(line + ["--reduced", "--device", "cpu"])
    assert "not 'ssm'" in capsys.readouterr().err


def test_mesh_flag_parses(monkeypatch):
    from repro_torch.launch.mesh import parse_mesh
    assert parse_mesh("none") is None and parse_mesh("") is None
    assert parse_mesh(None) is None
    with pytest.raises(ValueError, match="DxM"):
        parse_mesh("2by1", device="cpu")
    got = _port(monkeypatch, ["--arch", "llama2-7b", "--mesh", "none"])
    assert got["config"].mesh is None
