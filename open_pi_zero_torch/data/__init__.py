"""The data layer (counterpart of the JAX package's ``data/``), without
TensorFlow: TFRecord files and the ``tf.train.Example`` wire format
(``tfrecord``, ``tf_example``), a PNG codec (``images``), RLDS episodes
(``rlds``), statistics and normalization, the OXE transforms and mixes
(``oxe``), trajectory and frame transforms, and the weighted interleave
(``pipeline``), in numpy and threads. JPEG decoding, the extended OXE
registry and the tokenizer's text processing wait in ROADMAP.md queue 1."""
