"""Backend dispatch + hybrid-split walkthrough
(reference: example/example_hybridmode.cpp).

Where the reference splits a modexp vector between QAT and AVX512 by a
tunable ratio (ipcl/mod_exp.cpp:688-732), this framework splits each batch
between its two modexp backends — RNS (the default) and the limb-serial
CIOS fallback ("xla") — with the same policy API (set_hybrid_mode /
set_hybrid_ratio / set_hybrid_off); the OPTIMAL default keeps the whole
batch on the primary backend.
"""

import time

import pailliercryptolib_tpu as ptpu


def time_encrypt(key, pt, label):
    key.pub_key.encrypt(pt)  # warm (compile)
    t = time.time()
    ct = key.pub_key.encrypt(pt)
    ct.block_until_ready()
    print(f"{label:>16}: {(time.time()-t)*1000:7.1f} ms / {len(pt)} encrypts")
    return ct


def main():
    from pailliercryptolib_tpu.ops.dispatch import default_backend

    print("default backend:", default_backend())
    key = ptpu.generate_keypair(1024, enable_DJN=True)
    pt = ptpu.PlainText(list(range(1, 257)))

    # OPTIMAL (default): the whole batch on the RNS backend
    ct = time_encrypt(key, pt, "OPTIMAL")
    assert key.priv_key.decrypt(ct).texts == pt.texts

    # a manual 75/25 split: head on RNS, tail on CIOS, dispatched
    # concurrently (the reference's QAT-head/IPP-tail std::thread)
    ptpu.set_hybrid_ratio(0.75)
    ct = time_encrypt(key, pt, "ratio 0.75")
    assert key.priv_key.decrypt(ct).texts == pt.texts

    # everything on the CIOS fallback (the reference's HybridMode::IPP)
    ptpu.set_hybrid_mode(ptpu.HybridMode.XLA)
    ct = time_encrypt(key, pt, "HybridMode.XLA")
    assert key.priv_key.decrypt(ct).texts == pt.texts

    ptpu.set_hybrid_off()


if __name__ == "__main__":
    main()
