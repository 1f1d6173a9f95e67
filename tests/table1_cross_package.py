"""Table 1's quantizers across the packages, on the CPU, by hand (not a
pytest module: ~4 minutes):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/table1_cross_package.py

bert-tiny fine-tuned by the port (``launch.table1.train_bert``, the emotion
task at the JAX package's defaults: 3200 training examples, 8 epochs),
then each (bits, method) quantized by the JAX package's ``quantize_tree``
(evaluated on its ``dequantize_tree``) and by the port's (evaluated as
quantized), on the same weights and the same 800 test examples. Prints
each pair of accuracies: the baseline draws no random numbers and should
agree exactly; SplitQuant's k-means seeds differ between the packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch
from repro.core import QuantConfig, QuantPolicy, dequantize_tree, quantize_tree
from repro.models import bert_tiny as jbert

from repro_torch.launch import table1


def to_jax(tree):
    """The port's tree as JAX's: a layer stack stacked on axis 0."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        per = [to_jax(v) for v in tree]
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per)
    return jnp.asarray(tree.detach().numpy())


def main():
    torch.set_num_threads(4)
    (name, tr, te), = table1.datasets(4000, 0)[:1]
    cfg, params = table1.train_bert(tr, epochs=8, seed=0, device="cpu")
    jp, jcfg = to_jax(params), get_arch("bert-tiny")
    fwd = jax.jit(lambda p, b: jbert.forward(p, jcfg, b))

    def jax_accuracy(p):
        right = 0
        for i in range(0, len(te.labels), 100):
            b = {"tokens": jnp.asarray(te.tokens[i:i + 100]),
                 "mask": jnp.asarray(te.mask[i:i + 100])}
            right += int((np.asarray(fwd(p, b)).argmax(-1) ==
                          te.labels[i:i + 100]).sum())
        return right / len(te.labels)
    print(f"{name} fp32: port {table1.evaluate(cfg, params, te)} jax "
          f"{jax_accuracy(jp)}")
    for bits in table1.BITS:
        for method in ("baseline", "splitquant"):
            q, _ = quantize_tree(jax.random.PRNGKey(0), jp, QuantPolicy(
                cfg=QuantConfig(bits=bits), method=method, k=3))
            print(f"int{bits} {method}: jax {jax_accuracy(dequantize_tree(q))}"
                  f" port {table1.quantized_accuracy(cfg, params, te, bits, method)}")


if __name__ == "__main__":
    main()
