"""Distribution over ``torch.distributed`` ranks (counterpart of
``acf_tpu/parallel/``): the ("data", "model") mesh, per-rank input rows,
row-sharded tables, sharded evaluation and serving, and a launcher of
ranks."""
