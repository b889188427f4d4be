"""Subprocess child for the port's WAL kill-durability test.

Runs the reference child's deterministic insert/delete churn
(``_wal_churn_child.script``) through the port's ``RFANNEngine`` over the
port's ``StreamingRFANN`` on the CPU, with a WAL attached, appending one
line to an ack file after each mutation returns (i.e. after the WAL
acknowledged it).  The parent test SIGKILLs this process mid-churn and
recovers from the checkpoint + WAL tail with both packages.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _wal_churn_child import BUILD, corpus, script  # noqa: E402


def main(wal_dir: str, ckpt_dir: str, ack_path: str) -> None:
    import torch
    from repro_torch.serving.engine import RFANNEngine
    from repro_torch.streaming import StreamingRFANN

    torch.set_num_threads(1)
    vecs, attrs = corpus()
    idx = StreamingRFANN(vecs, attrs, max_delta=64, device="cpu", **BUILD)
    eng = RFANNEngine(idx, k=4, ef=16, wal_dir=wal_dir, index_path=ckpt_dir)
    # O_APPEND + one write per line: each ack hits the file before the
    # next mutation starts, so the parent's read is a true prefix count
    fd = os.open(ack_path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
    os.write(fd, b"READY\n")
    for i, op in enumerate(script()):
        if op[0] == "I":
            eng.insert(op[2], op[3], ext_id=op[1])
        else:
            eng.delete(op[1])
        os.write(fd, f"{i + 1}\n".encode())
    os.write(fd, b"DONE\n")
    eng.close()
    idx.close()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3])
