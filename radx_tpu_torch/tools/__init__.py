"""The port's measuring tools on the card (counterparts of the JAX
package's ``tools/``): ``bench_strategies`` (radix vs bitonic),
``autotune`` (the tile sweep and its ``TUNING`` row), ``dryrun_scale``
(the distributed sort at 16 / 32 shards) and ``scaling_model`` (config 5's
scaling model on rates measured on the card, and the exchange audit)."""
