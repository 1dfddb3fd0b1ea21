"""Process set-up helpers (genome_tpu/runtime.py), the launcher's
`--local-device-ids`, and the pure-Python parts of chip_smoke.py."""

import json
import os
import subprocess

import pytest

import chip_smoke
from genome_tpu import runtime


@pytest.fixture
def restore_cache_dir():
    import jax
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_env_set_is_left_alone(monkeypatch, restore_cache_dir):
    import jax
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert runtime.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_env_unset_uses_checkout(monkeypatch, restore_cache_dir):
    import jax
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = runtime.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    assert os.path.isdir(got)


def test_cache_dir_is_fixed(monkeypatch, tmp_path, restore_cache_dir):
    # independent of the working directory and of the process
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    a = runtime.enable_compile_cache()
    monkeypatch.chdir(tmp_path)
    assert runtime.enable_compile_cache() == a == runtime.CACHE_DIR


def test_cache_dir_is_git_ignored():
    repo = runtime.REPO_ROOT
    with open(os.path.join(repo, ".gitignore")) as f:
        ignored = {line.strip() for line in f}
    name = os.path.basename(runtime.CACHE_DIR)
    assert f"{name}/" in ignored or name in ignored


@pytest.mark.parametrize("text,want", [("0", [0]), ("3", [3]),
                                       ("0,2", [0, 2])])
def test_parse_device_ids(text, want):
    assert runtime.parse_device_ids(text) == want


@pytest.mark.parametrize("text", ["", "a", "0,0", "-1", "1,,2"])
def test_parse_device_ids_rejects(text):
    with pytest.raises(ValueError):
        runtime.parse_device_ids(text)


def test_launcher_local_device_ids_reach_initialize(monkeypatch):
    """--local-device-ids is parsed and handed to jax.distributed."""
    from genome_tpu.dist import launch, multihost
    seen = {}

    class Stop(Exception):
        pass

    def fake_init(coordinator, num_processes, process_id,
                  local_device_ids=None):
        seen.update(coordinator=coordinator, n=num_processes,
                    pid=process_id, ids=local_device_ids)
        raise Stop

    monkeypatch.setattr(multihost, "initialize", fake_init)
    monkeypatch.setattr(launch, "enable_compile_cache", lambda: None)
    with pytest.raises(Stop):
        launch.main(["r.fq", "--num-processes", "4", "--process-id", "2",
                     "--coordinator", "localhost:1234",
                     "--local-device-ids", "2"])
    assert seen == dict(coordinator="localhost:1234", n=4, pid=2, ids=[2])


def test_launcher_rejects_bad_device_ids(capsys):
    from genome_tpu.dist import launch
    with pytest.raises(SystemExit):
        launch.main(["r.fq", "--num-processes", "1", "--process-id", "0",
                     "--local-device-ids", "x"])
    assert "device ids" in capsys.readouterr().err


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n\n",
     [("NVIDIA H100 80GB HBM3", "500.00 W"),
      ("NVIDIA H100 80GB HBM3", "700.00 W")]),
])
def test_smoke_parses_nvidia_smi(text, want):
    assert chip_smoke.parse_gpu_query(text) == want


@pytest.mark.parametrize("text", ["", "\n", "no comma here\n", ", 700 W\n"])
def test_smoke_rejects_bad_nvidia_smi(text):
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.parse_gpu_query(text)


def test_smoke_result_line_format():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_smoke_four_cards_selects_only_its_phases():
    four = chip_smoke.phases_for(True)
    one = chip_smoke.phases_for(False)
    assert four == ("launcher_4proc", "sharded_4card")
    assert not set(four) & set(one)
    assert one[0] == "gpu_tests"


class _Dev:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("platform", ["cpu", "rocm", "METAL"])
def test_smoke_refuses_non_gpu_platform(platform):
    with pytest.raises(chip_smoke.SmokeError, match="not 'gpu'"):
        chip_smoke.require_gpu([_Dev(platform)], 1)


def test_smoke_requires_enough_cards():
    chip_smoke.require_gpu([_Dev("gpu")] * 4, 4)
    with pytest.raises(chip_smoke.SmokeError, match="need 4"):
        chip_smoke.require_gpu([_Dev("gpu")], 4)


def test_smoke_fails_without_a_card(tmp_path):
    """On a machine with no GPU the script exits non-zero and prints no
    result line."""
    env = dict(os.environ, PATH=str(tmp_path))  # no nvidia-smi on PATH
    proc = subprocess.run(
        [os.sys.executable, chip_smoke.__file__], env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
