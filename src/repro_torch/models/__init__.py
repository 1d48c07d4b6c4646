"""The LM stack's serving path (port of ``repro.models``), dense family.

* ``config`` — :class:`ModelConfig`, :class:`PSpec` parameter declarations,
  seeded initialisation from a ``torch.Generator``, ``count_params``.
* ``layers`` — rmsnorm, the three RoPE styles, embedding and output head,
  GQA attention (full rectangle and q-chunked) and the gated MLP, as plain
  functions on tensors.
* ``decode`` — the KV cache and one-token GQA attention.
* ``blocks`` — the dense block (:class:`DenseBlock`) and its
  forward / prefill / decode functions.
* ``model`` — :class:`Model`, an ``nn.Module`` over a ``ModuleList`` of
  dense blocks: ``forward`` logits, ``prefill`` and ``decode_step``.
* ``convert`` — ``params_from_reference``: the reference's parameter tree
  (numpy arrays) loaded into a :class:`Model`.
"""
