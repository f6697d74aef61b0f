'''
Real 2-process jax.distributed run (tools/distributed_2proc.py): two
coordinator-connected CPU processes render a row-sharded film over the
2-process global mesh and verify their bands against a local render.
'''

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, 'tools', 'distributed_2proc.py')


def test_two_process_distributed_render(tmp_path):
    out_json = str(tmp_path / 'result.json')
    r = subprocess.run(
        [sys.executable, TOOL, '--res', '64', '--spp', '4',
         '--out', out_json],
        capture_output=True, text=True, timeout=540, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads([l for l in r.stdout.splitlines()
                      if l.startswith('{')][-1])
    assert out['procs'] == 2
    assert out['process_count_seen'] == [2, 2]  # is_distributed() was true
    assert out['band_allclose'] is True
    with open(out_json) as f:
        assert json.load(f) == out
