"""The port's launchers, ``examples_torch/run_*.sh``, against the JAX
package's ``examples/run_*.sh``: one port script per JAX script, the same
flag block token for token (parsed to the same RunConfig by both packages'
``parse_args``), ``python -m ivfhnsw_tpu_torch.drivers.<the same driver>``;
then each of the seven drivers run through its port launcher on the CPU
(``-device cpu`` appended) at a tiny synthetic size, in one temporary tree
laid out by ``examples/setup_env.sh``.
"""

import glob
import os
import re
import shlex
import shutil
import subprocess

import numpy as np
import pytest

from ivfhnsw_tpu.utils.config import parse_args as jax_parse_args
from ivfhnsw_tpu_torch.utils.config import parse_args as torch_parse_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = sorted(os.path.basename(p) for p in
               glob.glob(os.path.join(REPO, "examples", "run_*.sh")))
# the drivers' own flags, which parse_args never sees
DRIVER_FLAGS = ("orcv_home", "segment_dir")
TINY = ["-synthetic", "0", "-d", "16", "-nc", "32", "-nb", "6000", "-nt",
        "3000", "-nq", "50", "-code_size", "4", "-nprobe", "8", "-max_codes",
        "500", "-k", "10"]


def read_launcher(path: str):
    """(driver module, flag block text, flag tokens with $data / $model
    given fixed values) of a launcher: the ``python -m`` line and the lines
    after it up to ``"$@"``."""
    text = open(path).read()
    m = re.search(r'^python -m ([\w.]+) \\\n(.*?) "\$@"\s*$', text,
                  re.M | re.S)
    assert m, f"{path}: no python -m line ending in \"$@\""
    block = m.group(2)
    tokens = shlex.split(block.replace("\\\n", " ").replace(
        "$data", "/d").replace("$model", "/m"))
    return m.group(1), block, tokens


def parse_flags(parse, tokens):
    argv = list(tokens)
    for flag in DRIVER_FLAGS:
        if "-" + flag in argv:
            i = argv.index("-" + flag)
            del argv[i:i + 2]
    return parse(argv).to_json()


def test_one_port_launcher_per_jax_launcher():
    ported = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(REPO, "examples_torch", "run_*.sh")))
    assert len(NAMES) == 18 and ported == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_flag_block_and_driver_match(name):
    jax_mod, jax_block, jax_tokens = read_launcher(
        os.path.join(REPO, "examples", name))
    port = os.path.join(REPO, "examples_torch", name)
    mod, block, tokens = read_launcher(port)
    assert os.access(port, os.X_OK)
    assert block.split() == jax_block.split() and tokens == jax_tokens
    assert jax_mod.startswith("ivfhnsw_tpu.drivers.")
    assert mod == "ivfhnsw_tpu_torch.drivers." + jax_mod.rsplit(".", 1)[1]
    assert os.path.exists(os.path.join(REPO, *mod.split(".")) + ".py")
    assert (parse_flags(torch_parse_args, tokens)
            == parse_flags(jax_parse_args, jax_tokens))
    text = open(port).read()
    assert 'cd "$(dirname "$0")/.."' in text
    assert re.findall(r"python -m ([\w.]+)", text) == [mod]
    assert "ivfhnsw_tpu." not in text.replace("ivfhnsw_tpu_torch.", "")
    # the same data/ and models/ layout
    for var in ("data", "model"):
        pat = rf'^{var}="\$\{{PWD\}}/\w+/\w+"$'
        assert (re.findall(pat, text, re.M)
                == re.findall(pat, open(os.path.join(
                    REPO, "examples", name)).read(), re.M) != [])


def run_launcher(root, name, extra, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    r = subprocess.run(["bash", os.path.join(root, "examples_torch", name),
                        *extra, "-device", "cpu"], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=root)
    assert r.returncode == 0, f"{name}: {r.stderr[-3000:]}"
    return r.stdout


def test_each_driver_through_its_launcher_on_the_cpu(tmp_path):
    """The seven drivers, each through one port launcher, chained over one
    tree: setup_env.sh makes data/ and models/; run_sift1b.sh computes and
    writes the coarse centroids and assignments that the later launchers
    load (same -nc, -nb, -d); the grouping launchers share one OPQ
    quantizer set and index; vector_add reads two base segments of the
    synthetic corpus from data/SIFT1B/segments."""
    from ivfhnsw_tpu_torch.drivers.common import SyntheticDataset
    from ivfhnsw_tpu_torch.utils import io
    root = str(tmp_path)
    for d in ("examples", "examples_torch"):
        os.makedirs(os.path.join(root, d))
    shutil.copy(os.path.join(REPO, "examples", "setup_env.sh"),
                os.path.join(root, "examples"))
    for name in NAMES:
        shutil.copy(os.path.join(REPO, "examples_torch", name),
                    os.path.join(root, "examples_torch"))
    subprocess.run(["bash", os.path.join(root, "examples", "setup_env.sh")],
                   check=True, capture_output=True, timeout=60)
    data = os.path.join(root, "data", "SIFT1B")
    model = os.path.join(root, "models", "SIFT1B")
    seg = os.path.join(data, "segments")
    os.makedirs(seg)
    cfg = torch_parse_args(TINY[2:])
    base = SyntheticDataset(cfg, 0, "cpu").base
    for i, part in enumerate(np.array_split(base, 2)):
        io.write_xvec(os.path.join(seg, f"base_{i:02d}.fvecs"), part)
    grouping = TINY + ["-nsubc", "8"]
    out = {}
    for name, extra in (("run_sift1b.sh", TINY), ("run_sift1b_enn.sh", TINY),
                        ("run_sift1b_grouping_OPQ.sh", grouping),
                        ("run_sift1b_grouping_OPQ_disk.sh", grouping),
                        ("run_sift1b_grouping_OPQ_vector_add.sh", grouping),
                        ("run_mkindex.sh", grouping),
                        ("run_sift1b_orca.sh", TINY)):
        out[name] = run_launcher(root, name, extra)
    for name in ("run_sift1b.sh", "run_sift1b_grouping_OPQ.sh",
                 "run_sift1b_grouping_OPQ_disk.sh",
                 "run_sift1b_grouping_OPQ_vector_add.sh"):
        r1 = [float(ln.split()[1]) for ln in out[name].splitlines()
              if ln.startswith("Recall@1:")]
        assert r1 and all(0.0 < r <= 1.0 for r in r1), (name, out[name])
    assert "Recall@" in out["run_sift1b_enn.sh"]
    # run_sift1b.sh wrote the shared coarse artifacts; the grouping
    # launchers loaded them and wrote their own quantizers and index
    for path in (os.path.join(data, "centroids_sift1b.fvecs"),
                 os.path.join(data, "precomputed_idxs_sift1b.ivecs"),
                 os.path.join(model, "ivfhnsw_PQ16.index"),
                 os.path.join(model, "pq16_opq_g64.pq"),
                 os.path.join(model, "opq16.opq"),
                 os.path.join(model, "ivfhnsw_PQ16_opq_g64.index_01.index"),
                 os.path.join(model, "orcv_home", "hdr.vec"),
                 os.path.join(root, "centroids_hit.log")):
        assert os.path.exists(path), path
    assert "loading" in out["run_sift1b_grouping_OPQ.sh"]
