"""The port's CLI (``python -m hhe_tpu_torch.parties.cli``) on the CPU:
csp, analyst and user as three processes on fixed localhost ports
(50981-50982, this file's alone) at N=1024 / 13 limbs, with surrogate weight
and data CSVs; the analyst's printed predictions must equal the plain
model's.  A missing input file ends a party with ``FileNotFoundError``."""

import argparse
import os
import queue
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path

import grpc
import numpy as np
import pytest

from hhe_tpu_torch.models import pocketnn
from hhe_tpu_torch.parties import cli, rpc
from hhe_tpu_torch.parties.gen import hhe_pb2 as pb

ROOT = Path(__file__).resolve().parents[1]
ANALYST_ADDR = "localhost:50981"
CSP_ADDR = "localhost:50982"
SMALL = ("--device", "cpu", "--n", "1024")
ENV = dict(os.environ, OMP_NUM_THREADS="2")  # several test workers share the CPU
TIMEOUT = 240  # seconds for any one step


def party_cmd(*args):
    return [sys.executable, "-m", "hhe_tpu_torch.parties.cli", *args, *SMALL]


class Party:
    """A CLI process whose output lines are collected on a thread."""

    def __init__(self, *args):
        self.proc = subprocess.Popen(
            party_cmd(*args), cwd=ROOT, env=ENV, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        self.lines = queue.Queue()
        self.seen = []
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line)

    def wait_for(self, pattern, timeout=TIMEOUT):
        """The first match of `pattern` in a line not yet searched."""
        rx = re.compile(pattern)
        while True:
            try:
                line = self.lines.get(timeout=timeout)
            except queue.Empty:
                raise AssertionError(f"no {pattern!r} in {timeout} s; output: {self.seen}")
            self.seen.append(line)
            m = rx.search(line)
            if m:
                return m


def test_cli_three_processes_predict_like_the_plain_model(tmp_path):
    rng = np.random.default_rng(24)  # predictions [0, 1]
    w = rng.integers(-3, 4, (300, 1))
    x = rng.integers(0, 32, (4, 300))
    pocketnn.save_csv_matrix(tmp_path / "weights.csv", w)
    data = tmp_path / "c000101_data.txt"
    pocketnn.save_csv_matrix(data, x)
    parties = []
    try:
        csp = Party("csp", CSP_ADDR, "--workdir", str(tmp_path))
        parties.append(csp)
        csp.wait_for(r"\[CSP\] serving on")
        analyst = Party("analyst", ANALYST_ADDR, CSP_ADDR, "--weights",
                        str(tmp_path / "weights.csv"), "--input-len", "300")
        parties.append(analyst)
        uuid = analyst.wait_for(r"\[Analyst\] uuid=(\S+)")[1]
        analyst.wait_for(r"\[Analyst\] ready")
        user = subprocess.run(
            party_cmd("user", ANALYST_ADDR, CSP_ADDR, "--data", str(data), "--rows", "2"),
            cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=TIMEOUT,
        )
        assert user.returncode == 0, user.stdout + user.stderr
        assert "[User] done" in user.stdout
        fname = f"c000101_{uuid}.bin"
        assert (tmp_path / fname).exists()  # the CSP's decomposition checkpoint

        with grpc.insecure_channel(CSP_ADDR) as channel:
            evaluate = channel.unary_unary(
                f"/{rpc.CSP_SERVICE}/evaluateModelFromFile",
                request_serializer=pb.DataFile.SerializeToString,
                response_deserializer=pb.Empty.FromString,
            )
            evaluate(pb.DataFile(filename=fname), timeout=TIMEOUT)
        got = analyst.wait_for(r"predictions so far: \[([-\d, ]*)\]")[1]
        expect = (x[:2].astype(np.int64) @ w.reshape(-1) > 0).astype(int)
        assert [int(v) for v in got.split(",")] == expect.tolist()

        for p in (analyst, csp):
            p.proc.send_signal(signal.SIGINT)
            assert p.proc.wait(timeout=60) == 0
    finally:
        for p in parties:
            if p.proc.poll() is None:
                p.proc.kill()
                p.proc.wait()


@pytest.mark.parametrize("party,flag", [("user", "--data"), ("analyst", "--weights")])
def test_cli_missing_input_file_raises(tmp_path, party, flag):
    proc = subprocess.run(
        party_cmd(party, flag, str(tmp_path / "c000101_data.txt")),
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=TIMEOUT,
    )
    assert proc.returncode != 0
    assert "FileNotFoundError" in proc.stderr, proc.stderr


def test_cli_parties_draw_their_own_seeds():
    """Each process's party gets fresh randomness (the JAX CLI seeds every
    party with 0, so its CSP's secret key is the analyst's)."""
    args = argparse.Namespace(n=1024, limbs=13)
    assert len({cli._params(args).seed for _ in range(4)}) == 4
    assert cli._params(args).n == 1024 and cli._params(args).data_limbs == 13
