"""CLI smoke tests: convert -> packed dir -> generate (raw ids, no tokenizer)."""

from xbitops.cli import main


def test_cli_convert_and_generate(tmp_path, capsys):
    # build a tiny AutoGPTQ checkpoint via the io test fixture factory
    import tests.test_io as tio

    class F:
        def mktemp(self, name):
            d = tmp_path / name
            d.mkdir()
            return d

    d, _ = tio.ckpt_dir.__wrapped__(F())
    out = tmp_path / "packed"
    assert main(["convert", "--ckpt", str(d), "--out", str(out)]) == 0
    assert (out / "manifest.json").exists() and (out / "config.json").exists()

    assert main([
        "generate", "--ckpt", str(out), "--prompt", "5 9 2",
        "--max-tokens", "3", "--slots", "1", "--max-seq-len", "32",
    ]) == 0
    got = capsys.readouterr().out
    assert "(length)" in got
