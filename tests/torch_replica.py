"""A replica program for the fleet tests: a port REST server on the CPU
whose ``/v1/pw_ai_answer`` answers ``{"response": "<tag>:<prompt>"}`` through a
``pw.run()`` dataflow, with the observability routes (``/healthz``,
``/readyz``, ``/v1/statistics``, ``/metrics``) and the GET
``/v1/phase21`` report of ``chip_smoke.py``'s replicas (no memory, no
launches here). No model: the process stands for a replica in what the
fleet sees of it.

    python -m tests.torch_replica [--tag T] --port PORT
"""

import argparse
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="r")
    ap.add_argument("--port", type=int, required=True)
    args = ap.parse_args(argv)

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.xpacks.llm.servers import BaseRestServer

    class Question(pw.Schema):
        prompt: str

    srv = BaseRestServer("127.0.0.1", args.port)
    srv.serve("/v1/pw_ai_answer", Question, lambda q: q.select(
        result=pw.apply(lambda p: {"response": f"{args.tag}:{p}"}, q.prompt)))
    srv.webserver._register("/v1/phase21", ["GET"], lambda _p: {
        "pid": os.getpid(), "max_memory_allocated": 0, "launches": {}})
    srv.run()


if __name__ == "__main__":
    main()
