"""The stack sampler (``repro_torch.benchmarks.stack_sample``) on a small
script on the CPU: the script's busy function is filed inclusive and
innermost, its caller inclusive only, and the exit code passes through."""
import json
import textwrap

from repro_torch.benchmarks import stack_sample

SCRIPT = textwrap.dedent("""
    import sys, time

    def busy(seconds):
        t = time.perf_counter()
        while time.perf_counter() - t < seconds:
            pass

    def outer():
        busy(0.3)

    if __name__ == "__main__":
        outer()
        sys.exit(int(sys.argv[1]))
""")


def test_the_busy_function_holds_the_samples(tmp_path):
    path = tmp_path / "busy_script.py"
    path.write_text(SCRIPT)
    rc, out = stack_sample.sample(str(path), ["3"], ["busy_script.py"], interval=0.005)
    assert rc == 3
    incl, inner = dict(out["inclusive"]), dict(out["innermost"])
    assert out["samples"] > 10
    assert incl["busy_script.py:busy"] >= 0.5 * 0.3
    assert incl["busy_script.py:outer"] >= incl["busy_script.py:busy"]
    assert inner["busy_script.py:busy"] >= 0.5 * 0.3 and "busy_script.py:outer" not in inner
    assert any(c.startswith("busy < outer") for c, _ in out["chains"])


def test_main_writes_the_readings(tmp_path):
    path = tmp_path / "busy_script.py"
    path.write_text(SCRIPT)
    out = tmp_path / "o" / "sample.json"
    rc = stack_sample.main([str(path), "--out", str(out), "--interval", "0.005", "--", "0"])
    assert rc == 0
    got = json.loads(out.read_text())
    assert dict(got["inclusive"])["busy_script.py:busy"] > 0
