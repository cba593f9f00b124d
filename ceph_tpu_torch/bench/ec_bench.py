"""ceph_erasure_code_benchmark-compatible CLI.

Flag and output parity with the reference harness
(reference: src/test/erasure-code/ceph_erasure_code_benchmark.cc:40-139):
``--plugin --workload --size --iterations --erasures --erased
--erasures-generation --parameter k=v``; output is one line
``<elapsed_seconds>\t<iterations * size/1024 KiB>`` (:179,310), so
MiB/s = (KiB/1024)/seconds exactly as qa/workunits/erasure-code/bench.sh
computes it.

Extensions (off by default; defaults match the reference):
  --batch B      encode/decode B stripes per device launch through the
                 plugin codec (cross-stripe batching)
  --device-resident   keep the stripes in tensors on the codec's device
                 between iterations and time the launches alone (CUDA
                 events on the card), excluding host<->device copies
  --directory    plugin directory (erasure_code_dir analog)

Run: ``python -m ceph_tpu_torch.bench.ec_bench --plugin torch_rs
-P k=8 -P m=4 --batch 64 --device-resident``.
"""
from __future__ import annotations

import argparse
import random
import sys
import time

import numpy as np
import torch

from ..plugins.registry import ErasureCodePluginRegistry


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ec_bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-s", "--size", type=int, default=1024 * 1024,
                   help="size of the buffer to be encoded")
    p.add_argument("-i", "--iterations", type=int, default=1)
    p.add_argument("-p", "--plugin", default="jerasure")
    p.add_argument("-w", "--workload", choices=["encode", "decode"],
                   default="encode")
    p.add_argument("-e", "--erasures", type=int, default=1)
    p.add_argument("--erased", type=int, action="append", default=[])
    p.add_argument("-E", "--erasures-generation", dest="erasures_generation",
                   choices=["random", "exhaustive"], default="random")
    p.add_argument("-P", "--parameter", action="append", default=[],
                   metavar="KEY=VALUE")
    p.add_argument("--directory", default="")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--device-resident", dest="device_resident",
                   action="store_true")
    return p


def _time_device(codec, fn, iterations: int) -> float:
    """Seconds for ``iterations`` calls of ``fn`` after one warm call:
    CUDA events on the card, the host clock around a CPU codec."""
    fn()
    if codec.device != "cuda":
        begin = time.perf_counter()
        for _ in range(iterations):
            fn()
        return time.perf_counter() - begin
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iterations):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1000.0


class ErasureCodeBench:
    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.profile = {}
        for kv in args.parameter:
            if kv.count("=") != 1:
                print(f"--parameter {kv} ignored because it does not contain "
                      f"exactly one =", file=sys.stderr)
                continue
            key, value = kv.split("=")
            self.profile[key] = value
        self.k = int(self.profile.get("k", "7"))
        self.m = int(self.profile.get("m", "3"))

    def _factory(self):
        registry = ErasureCodePluginRegistry.instance()
        return registry.factory(self.args.plugin, self.args.directory,
                                self.profile)

    def _input(self) -> bytes:
        return b"X" * self.args.size

    def _report(self, elapsed: float, stripes: int) -> int:
        kib = self.args.iterations * stripes * (self.args.size // 1024)
        print(f"{elapsed:.6f}\t{kib}")
        return 0

    # -- encode (reference :151-181) ---------------------------------------

    def encode(self) -> int:
        ec = self._factory()
        data = self._input()
        want = set(range(ec.get_chunk_count()))
        if self.args.batch > 1 or self.args.device_resident:
            return self._encode_batched(ec, data)
        begin = time.perf_counter()
        for _ in range(self.args.iterations):
            ec.encode(want, data)
        return self._report(time.perf_counter() - begin, 1)

    def _encode_batched(self, ec, data: bytes) -> int:
        batch = self.args.batch
        prepared = ec.encode_prepare(data)
        k = ec.get_data_chunk_count()
        stripe = np.stack([prepared[ec.chunk_index(i)] for i in range(k)])
        folded = np.broadcast_to(stripe, (batch,) + stripe.shape)
        folded = np.ascontiguousarray(
            folded.swapaxes(0, 1).reshape(k, batch * stripe.shape[1]))
        codec = ec.codec
        if self.args.device_resident:
            dev = codec.to_device(folded)
            elapsed = _time_device(codec, lambda: codec.encode_device(dev),
                                   self.args.iterations)
        else:
            codec.encode(folded)                            # warm
            begin = time.perf_counter()
            for _ in range(self.args.iterations):
                codec.encode(folded)
            elapsed = time.perf_counter() - begin
        return self._report(elapsed, batch)

    # -- decode (reference :246-311) ---------------------------------------

    def decode(self) -> int:
        ec = self._factory()
        data = self._input()
        n = ec.get_chunk_count()
        want = set(range(n))
        encoded = ec.encode(want, data)
        if self.args.erased:
            for i in self.args.erased:
                encoded.pop(i, None)

        if self.args.batch > 1 or self.args.device_resident:
            return self._decode_batched(ec, encoded)

        begin = time.perf_counter()
        for _ in range(self.args.iterations):
            if self.args.erasures_generation == "exhaustive":
                code = self._decode_exhaustive(ec, encoded, encoded, 0,
                                               self.args.erasures)
                if code:
                    return code
            elif self.args.erased:
                ec.decode(want, encoded, 0)
            else:
                chunks = dict(encoded)
                for _ in range(self.args.erasures):
                    while True:
                        erasure = random.randrange(n)
                        if erasure in chunks:
                            break
                    del chunks[erasure]
                ec.decode(want, chunks, 0)
        return self._report(time.perf_counter() - begin, 1)

    def _decode_exhaustive(self, ec, all_chunks, chunks, i, want_erasures) -> int:
        """Try all erasure combinations, verifying content
        (reference decode_erasures :200-245)."""
        if want_erasures == 0:
            want_to_read = set(range(ec.get_chunk_count())) - set(chunks)
            decoded = ec.decode(want_to_read, chunks, 0)
            for chunk in want_to_read:
                if not np.array_equal(decoded[chunk], all_chunks[chunk]):
                    print(f"chunk {chunk} content and recovered content are "
                          f"different", file=sys.stderr)
                    return -1
            return 0
        for j in range(i, ec.get_chunk_count()):
            if j not in chunks:
                continue
            one_less = dict(chunks)
            del one_less[j]
            code = self._decode_exhaustive(ec, all_chunks, one_less, j + 1,
                                           want_erasures - 1)
            if code:
                return code
        return 0

    def _decode_batched(self, ec, encoded) -> int:
        n = ec.get_chunk_count()
        erased = self.args.erased or \
            sorted(random.sample(range(n), self.args.erasures))
        src = [i for i in range(n) if i not in erased][:ec.get_data_chunk_count()]
        stripe = np.stack([encoded[i] for i in src])
        batch = np.ascontiguousarray(
            np.broadcast_to(stripe, (self.args.batch,) + stripe.shape))
        codec = ec.codec
        if self.args.device_resident:
            dev = codec.to_device(batch)
            elapsed = _time_device(
                codec, lambda: codec.decode_batch_device(dev, src, erased),
                self.args.iterations)
        else:
            codec.decode_batch(batch, src, erased)          # warm
            begin = time.perf_counter()
            for _ in range(self.args.iterations):
                codec.decode_batch(batch, src, erased)
            elapsed = time.perf_counter() - begin
        return self._report(elapsed, self.args.batch)

    def run(self) -> int:
        if self.args.workload == "encode":
            return self.encode()
        return self.decode()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return ErasureCodeBench(args).run()
    except (ValueError, FileNotFoundError, RuntimeError) as e:
        print(str(e), file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
