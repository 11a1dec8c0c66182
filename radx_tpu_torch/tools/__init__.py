"""The port's measuring tools on the card (counterparts of the JAX
package's ``tools/``): ``bench_strategies`` (radix vs bitonic),
``autotune`` (the tile sweep and its ``TUNING`` row) and ``dryrun_scale``
(the distributed sort at 16 / 32 shards)."""
