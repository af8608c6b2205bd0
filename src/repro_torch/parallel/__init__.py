"""Multi-device pieces over ``torch.distributed``: the sharding rule tables
(``sharding``), tensor-parallel compute over the "model" axis
(``tensor_parallel``), int8 compressed gradient reduction
(``compression``), the ring all-gather matmul (``collective_matmul``) and
the pipeline executor (``pipeline``)."""
