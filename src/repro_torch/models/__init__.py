"""The LM stack (port of ``repro.models``), every family: dense, MoE, SSM
(Mamba-2) and hybrid (Mamba-2 with a shared attention block), for serving
and for training.

* ``config`` — :class:`ModelConfig`, :class:`PSpec` parameter declarations,
  seeded initialisation from a ``torch.Generator``, ``count_params``.
* ``layers`` — rmsnorm, the three RoPE styles, embedding and output head,
  GQA attention (full rectangle and q-chunked) and the gated MLP, as plain
  functions on tensors.
* ``decode`` — the KV cache and one-token GQA attention.
* ``mla`` — Multi-head Latent Attention (DeepSeek): the expanded prefill,
  the absorbed decode step and its latent cache.
* ``moe`` — the MoE feed-forward: the f32 router, capacity dispatch, three
  batched expert products, the combine in a fixed order, shared experts.
* ``ssm`` — the Mamba-2 mixer: the causal convolution, the chunked SSD
  scan for the prefill, the O(1) recurrent decode step and its cache.
* ``blocks`` — the dense block (:class:`DenseBlock`: GQA or MLA, the gated
  MLP or MoE) and the Mamba-2 block (:class:`SSMBlock`), each with its
  forward / prefill / decode functions.
* ``model`` — :class:`Model`, an ``nn.Module`` over a ``ModuleList`` of
  blocks in the reference's stages (the hybrid's shared block held once
  and run from a plan): ``forward`` logits (per-layer remat when
  training), ``loss`` (chunked cross-entropy, the MTP loss),
  ``prefill`` and ``decode_step``, ``param_tree``.
* ``convert`` — ``params_from_reference``: the reference's parameter tree
  (numpy arrays) loaded into a :class:`Model`; ``stack_tree`` and
  ``reference_params``: the way back.
"""
