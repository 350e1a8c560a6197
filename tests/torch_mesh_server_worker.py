"""One rank of the tests' two-rank gloo server (no JAX in this process).

    python tests/torch_mesh_server_worker.py RANK WORLD INIT_FILE REQUESTS OUT \
        [lost]

Joins the group through ``file://INIT_FILE`` and builds the server's app
with ``--mesh data=2`` on the CPU (``serving/server.build_app``): vit_t16
from the repository's saved graph, seeded weights, groups of up to 2
collected for 300 ms. Rank 1 follows (``App.follow``) and writes the number
of calls it made to ``OUT.rank1``. Rank 0 serves HTTP on a free port and,
as a client, posts the pickled request bodies of ``REQUESTS`` (a dict:
``single``, the two bodies of ``pair`` at once, ``bad``, ``after``; then
``single`` to ``/debug_eval``), reads ``/health`` and ``/metrics``, then
shuts down (the followers' stop) and
writes what came back to ``OUT`` (a pickle). With ``lost`` rank 1 exits
once the app is built, without following, and rank 0 posts ``single``
and reads ``/health`` against the lost follower.
"""

import json
import os
import pickle
import sys
import threading
import urllib.error
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from interactive_vit_tpu_torch.serving.server import build_app  # noqa: E402


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as err:
        return err.code, err.read(), dict(err.headers)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def main(rank: int, world: int, init_file: str, requests: str, out: str,
         mode: str = ""):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    app = build_app(models=("vit_t16",), device="cpu", mesh_spec="data=2",
                    max_batch=2, max_wait_ms=300.0)
    if app.follower and mode == "lost":
        os._exit(0)  # gone without a word: no stop, no group teardown
    if app.follower:
        calls = app.follow()
        with open(out + f".rank{rank}", "w") as f:
            f.write(str(calls))
        dist.destroy_process_group()
        return
    with open(requests, "rb") as f:
        bodies = pickle.load(f)
    httpd = app.serve("127.0.0.1", 0, background=True)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    if mode == "lost":
        got = {"single": _post(url + "/compute", bodies["single"]),
               "after": _post(url + "/compute", bodies["after"]),
               "health": _get(url + "/health")}
        httpd.shutdown()
        app.close()
        with open(out, "wb") as f:
            pickle.dump(got, f)
        os._exit(0)  # the group's teardown would wait for the lost rank
    got = {"single": _post(url + "/compute", bodies["single"])}
    pair = [None, None]

    def one(j):
        pair[j] = _post(url + "/compute", bodies["pair"][j])

    threads = [threading.Thread(target=one, args=(j,)) for j in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got["pair"] = pair
    got["bad"] = _post(url + "/compute", bodies["bad"])
    got["after"] = _post(url + "/compute", bodies["after"])
    got["debug_eval"] = _post(url + "/debug_eval", bodies["single"])
    got["health"] = _get(url + "/health")
    got["metrics"] = _get(url + "/metrics")
    httpd.shutdown()
    app.close()
    with open(out, "wb") as f:
        pickle.dump(got, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7])
