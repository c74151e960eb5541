"""The source lint, the analysis report, its metrics and ``cli analyze``
(ROADMAP Queue 1, Slice F, item 15, part 15a:
``dlbb_tpu_torch/analysis/{findings,source_lint,__init__}.py``,
``obs/export.py::analysis_metrics``) against JAX's ``dlbb_tpu.analysis``.

JAX's ``lint_source`` and the port's give the same findings (rule, line,
severity) on the same source text for every rule whose source form the
two share: wall-clock reads and ``np.asarray``/``.item()`` syncs in Timer
blocks and perf_counter spans, the profiler wrappers there, unsorted set
iteration, non-atomic writes, the float64 numpy forms, and suppression
lines and files.  Each torch form of a rule has a positive and a negative
case.  The port's own files lint clean under ``--strict-warnings``.  A
report of the same findings writes JAX's JSON and summary, and
``analysis_metrics`` JAX's ``metrics.prom`` text; ``cli analyze`` returns
0, 1 and 2 where JAX's does; at world 1 every target pass audits nothing,
which is a finding (1), never a clean run.
"""

import dataclasses
import json
import textwrap
from pathlib import Path

import pytest

from dlbb_tpu import analysis as jax_analysis
from dlbb_tpu import cli as jax_cli
from dlbb_tpu.analysis import findings as jax_findings
from dlbb_tpu.analysis import source_lint as jax_lint
from dlbb_tpu.obs import calibration as jax_calibration
from dlbb_tpu.obs import export as jax_export
from dlbb_tpu_torch import cli
from dlbb_tpu_torch.analysis import findings as pt_findings
from dlbb_tpu_torch.analysis import source_lint as pt_lint
from dlbb_tpu_torch.obs import export as pt_export

REPO = Path(__file__).resolve().parents[1]


def _src(text):
    return textwrap.dedent(text).lstrip("\n")


def _keys(findings):
    return sorted((f.rule, int(f.location.rsplit(":", 1)[1]), f.severity) for f in findings)


# sources whose every finding comes from a rule form JAX and the port share
SHARED = {
    "wallclock": """
        import datetime
        import time

        def f(run, x):
            with Timer() as t:
                a = time.time()
                run(x)
            t0 = time.perf_counter()
            b = datetime.datetime.now()
            run(x)
            c = datetime.date.today()
            dt = time.perf_counter() - t0
            stamp = time.time()
            return dt, stamp
        """,
    "perf_counter_asarray": """
        import time
        import numpy as np

        def f(run, x):
            t0 = time.perf_counter()
            y = np.asarray(run(x))
            z = np.array(y)
            w = x.item()
            last = np.asarray(run(x))
            return time.perf_counter() - t0, last

        def g(run, x):
            with Timer():
                y = np.asarray(run(x))
                done = x.item()
            return y, done
        """,
    "profiler": """
        import time

        def f(run, x):
            t0 = time.perf_counter()
            with maybe_trace("d"):
                run(x)
            with annotate("step"):
                run(x)
            capture_device_trace(run, x)
            step_annotation("s", 1)
            run(x)
            return time.perf_counter() - t0
        """,
    "sets": """
        def f(a, b):
            out = []
            for k in set(a):
                out.append(k)
            for k in {1, 2, 3}:
                out.append(k)
            for k in set(a) | set(b):
                out.append(k)
            for k in sorted(set(a)):
                out.append(k)
            return out
        """,
    "atomic": """
        import json

        def f(path, d, fh):
            json.dump(d, fh)
            path.write_text(json.dumps(d))
            path.write_text(json.dumps(d) + "\\n")
            path.write_text("plain")
            return json.dumps(d)
        """,
    "float64_numpy": """
        import time
        import numpy as np

        def f(run, x):
            t0 = time.perf_counter()
            a = np.float64(x)
            b = x.astype(np.float64)
            c = x.astype("float64")
            d = x.astype(float)
            e = np.zeros(3)
            g = np.array([1.0, 2.0])
            h = np.ones(3, dtype=np.float32)
            i = np.full(3, 1.0, dtype=np.float64)
            run(x)
            dt = time.perf_counter() - t0
            outside = np.zeros(3)
            return dt, outside
        """,
    "suppressions": """
        import time

        def f(run, x):
            t0 = time.perf_counter()
            a = time.time()  # comm-lint: disable=wallclock-in-timed-region
            # comm-lint: disable=wallclock-in-timed-region
            b = time.time()
            c = time.time()
            run(x)
            return time.perf_counter() - t0
        """,
    "suppressed_file": """
        # comm-lint: disable-file=unsorted-set-iteration,non-atomic-artifact-write
        import json

        def f(a, fh):
            for k in set(a):
                json.dump(k, fh)
        """,
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_lint_equals_jax_on_shared_forms(case):
    source = _src(SHARED[case])
    jf, jsup = jax_lint.lint_source(source, "x.py")
    pf, psup = pt_lint.lint_source(source, "x.py")
    assert _keys(pf) == _keys(jf)
    assert psup == jsup
    assert pf or psup, f"{case}: the source exercises no rule"


def test_lint_rules_are_jax_less_missing_donation():
    assert pt_lint.LINT_RULES == tuple(r for r in jax_lint.LINT_RULES
                                       if r != "missing-donation")
    assert "missing-donation" not in pt_lint.LINT_RULES


# torch forms: (rule, positive source, negative source, path)
TORCH_FORMS = {
    "sync_cpu": ("host-sync-in-timed-region", """
        import time
        def f(run, x):
            t0 = time.perf_counter()
            y = run(x).cpu()
            run(y)
            return time.perf_counter() - t0
        """, """
        import time
        def f(run, x):
            t0 = time.perf_counter()
            run(x)
            y = run(x).cpu()
            return time.perf_counter() - t0, y
        """, "x.py"),
    "sync_cuda": ("host-sync-in-timed-region", """
        import time, torch
        def f(run, x):
            with Timer():
                run(x)
                torch.cuda.synchronize()
                run(x)
        """, """
        import time, torch
        def f(run, x):
            with Timer():
                run(x)
                torch.cuda.synchronize()
        """, "x.py"),
    "sync_float_of_call": ("host-sync-in-timed-region", """
        import time
        def f(run, x, n):
            t0 = time.perf_counter()
            v = float(x.sum())
            run(x)
            return time.perf_counter() - t0
        """, """
        import time
        def f(run, x, n):
            t0 = time.perf_counter()
            v = float(n)
            w = time_fn_per_iter(run, x, iterations=3, device="cuda")
            run(x)
            return time.perf_counter() - t0
        """, "x.py"),
    "sync_tolist_numpy": ("host-sync-in-timed-region", """
        import time
        def f(run, x):
            with Timer():
                a = x.tolist()
                b = x.numpy()
                run(x)
        """, """
        import time
        def f(run, x):
            with Timer():
                run(x)
            a = x.tolist()
        """, "x.py"),
    "transfer_in_loop": ("host-transfer-in-loop", """
        import torch
        def f(xs):
            out = []
            for x in xs:
                out.append(x.cpu())
                torch.cuda.synchronize()
            return out
        """, """
        import torch
        def f(xs, x):
            for mode in ("head", "whole"):
                x.cpu()
            for y in xs:
                if y is None:
                    print(x.cpu())
                    break
            later = []
            for y in xs:
                later.append(lambda: y.cpu())
            return later
        """, "x.py"),
    "transfer_in_loop_timing_home": ("host-transfer-in-loop", """
        def f(xs):
            return [x.numpy() for x in xs] + [x.numpy() for x in xs if x]
        """, """
        def f(xs):
            for x in xs:
                x.numpy()
        """, "dlbb_tpu_torch/utils/timing.py"),
    "profiler_torch": ("profiler-in-timed-region", """
        import time, torch
        def f(run, x):
            t0 = time.perf_counter()
            with torch.profiler.profile():
                run(x)
            with profile_session("cuda", "p"):
                run(x)
            run(x)
            return time.perf_counter() - t0
        """, """
        import time, torch
        def f(run, x):
            with torch.profiler.profile():
                run(x)
            t0 = time.perf_counter()
            run(x)
            return time.perf_counter() - t0
        """, "x.py"),
    "jit_in_loop": ("jit-in-loop", """
        import torch
        def f(xs, g):
            for i in xs:
                fn = torch.compile(lambda x: x * i)
                def inner(x):
                    return x + i
                h = torch.jit.script(inner)
                k = torch.cuda.make_graphed_callables(lambda x: x + i, (g,))
            return fn, h, k
        """, """
        import torch
        def f(xs, g):
            for i in xs:
                fn = torch.compile(g)
                h = torch.compile(lambda x: x * 2)
            return fn, h
        """, "x.py"),
    "float64_compiled": ("float64-literal-in-jit", """
        import torch
        @torch.compile
        def f(x):
            return x.double() + torch.zeros(3, dtype=torch.float64)

        def g(x):
            return x.to(torch.float64)
        step = torch.compile(g)

        def h(x):
            return x.to(torch.double)

        def capture(graph, x):
            with torch.cuda.graph(graph):
                return h(x)
        """, """
        import torch
        def f(x):
            return x.double() + torch.zeros(3, dtype=torch.float64)

        @torch.compile
        def g(x):
            return x.to(torch.float32)
        """, "x.py"),
    "float64_timed": ("float64-literal-in-jit", """
        import time, torch
        def f(run, x):
            t0 = time.perf_counter()
            y = x.to(torch.float64)
            run(y)
            return time.perf_counter() - t0
        """, """
        import time, torch
        def f(run, x):
            y = x.to(torch.float64)
            t0 = time.perf_counter()
            run(y)
            return time.perf_counter() - t0
        """, "x.py"),
}


@pytest.mark.parametrize("form", sorted(TORCH_FORMS))
def test_torch_forms_positive_and_negative(form):
    rule, positive, negative, path = TORCH_FORMS[form]
    pos, _ = pt_lint.lint_source(_src(positive), path)
    neg, _ = pt_lint.lint_source(_src(negative), path)
    if form == "transfer_in_loop_timing_home":
        # the timing API's home is exempt whatever it does in loops
        assert not [f for f in pos + neg if f.rule == rule]
        return
    assert [f for f in pos if f.rule == rule], form
    assert not [f for f in neg if f.rule == rule], [f.render() for f in neg]


def test_torch_form_counts():
    """Every site of a positive case is found, each once."""
    counts = {form: len([f for f in pt_lint.lint_source(_src(TORCH_FORMS[form][1]), "x.py")[0]
                         if f.rule == TORCH_FORMS[form][0]])
              for form in ("sync_tolist_numpy", "transfer_in_loop", "profiler_torch",
                           "jit_in_loop", "float64_compiled")}
    assert counts == {"sync_tolist_numpy": 2, "transfer_in_loop": 2, "profiler_torch": 2,
                      "jit_in_loop": 3, "float64_compiled": 4}


def test_syntax_error_and_suppression_reason():
    bad, _ = pt_lint.lint_source("def f(:\n", "bad.py")
    jbad, _ = jax_lint.lint_source("def f(:\n", "bad.py")
    assert [(f.rule, f.location) for f in bad] == [(f.rule, f.location) for f in jbad]
    # a reason may follow the rule list on the suppression's line
    src = _src("""
        import time
        def f(run):
            t0 = time.perf_counter()
            a = time.time()  # comm-lint: disable=wallclock-in-timed-region  a log stamp
            run()
            return time.perf_counter() - t0
        """)
    found, suppressed = pt_lint.lint_source(src, "x.py")
    assert not found and suppressed == 1


def test_the_port_lints_clean_under_strict_warnings():
    report = pt_lint.run_source_lint(root=str(REPO))
    assert [f.render() for f in report.findings] == []
    assert report.exit_code(strict_warnings=True) == pt_findings.EXIT_CLEAN
    assert report.files_linted > 80
    assert report.suppressed > 0


def test_a_wrong_root_is_an_error(tmp_path):
    report = pt_lint.run_source_lint(root=str(tmp_path / "nowhere"))
    assert [f.rule for f in report.findings] == ["no-files-linted"]
    assert report.exit_code() == pt_findings.EXIT_FINDINGS
    missing = pt_lint.run_source_lint(paths=[str(tmp_path / "gone.py")])
    assert [f.rule for f in missing.findings] == ["io-error"]


def _findings(mod):
    return [
        mod.Finding(pass_name="lint", rule="wallclock-in-timed-region",
                    severity=mod.SEVERITY_ERROR, target="a.py", message="m1",
                    location="a.py:3", details={"clock": "time.time()"}),
        mod.Finding(pass_name="hlo", rule="jit-in-loop", severity=mod.SEVERITY_WARNING,
                    target="t", message="m2"),
        mod.Finding(pass_name="hlo", rule="no-targets-audited",
                    severity=mod.SEVERITY_ERROR, target="<backend>", message="m3"),
    ]


def _report(mod, findings):
    report = mod.AnalysisReport()
    report.extend(mod.AnalysisReport(findings=findings, suppressed=2, files_linted=5,
                                     targets_audited=["x"],
                                     skipped_targets=[{"target": "y", "reason": "r"}]))
    return report


def test_report_json_and_summary_equal_jax(tmp_path):
    jr = _report(jax_findings, _findings(jax_findings))
    pr = _report(pt_findings, _findings(pt_findings))
    assert [f.name for f in dataclasses.fields(pt_findings.AnalysisReport)] \
        == [f.name for f in dataclasses.fields(jax_findings.AnalysisReport)]
    assert pr.to_dict() == jr.to_dict()
    assert pr.render_summary() == jr.render_summary()
    jr.write_json(tmp_path / "jax.json")
    pr.write_json(tmp_path / "port.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    for strict in (False, True):
        assert pr.exit_code(strict_warnings=strict) == jr.exit_code(strict_warnings=strict)
    warn_only = _report(pt_findings, _findings(pt_findings)[1:2])
    assert (warn_only.exit_code(), warn_only.exit_code(strict_warnings=True)) == (0, 1)
    assert _report(pt_findings, []).exit_code(strict_warnings=True) == 0


def test_analysis_metrics_equal_jax_metrics_prom(tmp_path):
    jr = _report(jax_findings, _findings(jax_findings))
    pr = _report(pt_findings, _findings(pt_findings))
    jtext = jax_export.analysis_metrics(jr).to_prometheus()
    assert pt_export.analysis_metrics(pr).to_prometheus() == jtext
    assert 'dlbb_analysis_findings{pass="numerics",severity="warning"} 0' in jtext
    # folded into a run's metrics.prom: the run's own families stay, a
    # re-run replaces only the analysis families (JAX's fold)
    existing = ("# TYPE dlbb_sweep_wall_seconds gauge\ndlbb_sweep_wall_seconds 3.5\n"
                + jax_export.analysis_metrics(jax_findings.AnalysisReport()).to_prometheus())
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "metrics.prom").write_text(existing)
    jax_calibration._fold_metrics(jax_export.analysis_metrics(jr),
                                  tmp_path / "jax" / "metrics.prom")
    pt_export.analysis_metrics(pr).fold_textfile(tmp_path / "port" / "metrics.prom")
    assert (tmp_path / "port" / "metrics.prom").read_text() == \
        (tmp_path / "jax" / "metrics.prom").read_text()
    pt_export.analysis_metrics(pr).fold_textfile(tmp_path / "fresh" / "metrics.prom")
    assert (tmp_path / "fresh" / "metrics.prom").read_text() == jtext


def _analyze_parser(parser):
    sub = next(a for a in parser._actions if a.dest == "cmd").choices["analyze"]
    which = next(a for a in sub._actions if a.dest == "which")
    return which.choices, which.default, {a.dest for a in sub._actions}


def test_analyze_parser_is_jax():
    pt_choices, pt_default, pt_flags = _analyze_parser(cli.build_parser())
    j_choices, j_default, j_flags = _analyze_parser(jax_cli.build_parser())
    assert tuple(pt_choices) == tuple(j_choices) and pt_default == j_default
    assert pt_flags == j_flags


def _tree(root, package, source):
    (root / package).mkdir(parents=True)
    (root / package / "mod.py").write_text(_src(source))
    return root


@pytest.mark.parametrize("source,want", [
    ("def f(x):\n    return sorted(set(x))\n", 0),
    ("import json\ndef f(d, fh):\n    json.dump(d, fh)\n", 1),
])
def test_cli_analyze_lint_exit_codes_equal_jax(tmp_path, source, want):
    jroot = _tree(tmp_path / "jax", "dlbb_tpu", source)
    proot = _tree(tmp_path / "port", "dlbb_tpu_torch", source)
    assert jax_cli.main(["analyze", "lint", "--root", str(jroot)]) == want
    assert cli.main(["analyze", "lint", "--root", str(proot)]) == want


def test_cli_analyze_wrong_root_and_crash_equal_jax(tmp_path, monkeypatch):
    nowhere = str(tmp_path / "nowhere")
    assert jax_cli.main(["analyze", "lint", "--root", nowhere]) == 1
    assert cli.main(["analyze", "lint", "--root", nowhere]) == 1

    def boom(*args, **kwargs):
        raise RuntimeError("lint crashed")

    monkeypatch.setattr(jax_analysis, "run_source_lint", boom)
    monkeypatch.setattr(pt_lint, "run_source_lint", boom)
    assert jax_cli.main(["analyze", "lint", "--root", nowhere]) == 2
    assert cli.main(["analyze", "lint", "--root", nowhere]) == 2


@pytest.mark.parametrize("which", ["schedule", "memory", "numerics", "all", "snapshot",
                                   "diff"])
def test_cli_analyze_refuses_part_15b(which, capsys, tmp_path):
    """The target passes run since part 15b; without ``--simulate`` every
    target is skipped, which is JAX's finding (1), and a snapshot of that
    audit is refused (nothing written)."""
    base = tmp_path / "baselines"
    assert cli.main(["analyze", which, "--baselines", str(base)]) == 1
    out = capsys.readouterr().out
    assert "no-targets-audited" in out and "not ported" not in out
    if which == "snapshot":
        assert "snapshot refused" in out and not base.exists()


def test_cli_analyze_hlo_without_ranks_is_never_clean(tmp_path, capsys):
    out = tmp_path / "out"
    report = tmp_path / "report.json"
    assert cli.main(["analyze", "hlo", "--json", str(report), "--output", str(out)]) == 1
    assert "no-targets-audited" in capsys.readouterr().out
    summary = json.loads(report.read_text())["summary"]
    assert summary["targets_audited"] == [] and len(summary["skipped_targets"]) == 41
    assert 'dlbb_analysis_findings{pass="hlo",severity="error"} 1' in \
        (out / "metrics.prom").read_text()
