"""Dataset preparation: raw annotations → the unified CSV schema.

The port's own copies of ``zsgnet_tpu/data/prep/``: converters for
Flickr30k Entities, ReferIt/RefClef and Visual Genome region descriptions,
plus zero-shot split construction (cases 0–3). They read the raw releases
with pandas and the standard library and write the same CSVs as the JAX
package's converters. Each module is a CLI:

    python -m zsgnet_tpu_torch.data.prep.flickr30k --annotations ... --out data/flickr30k
    python -m zsgnet_tpu_torch.data.prep.referit --refer-dir ... --out data/refclef
    python -m zsgnet_tpu_torch.data.prep.visual_genome --regions ... --out data/vg
    python -m zsgnet_tpu_torch.data.prep.zero_shot_splits --help

Output schema (shared by every family — see data/dataset.py):
    img_id, x1, y1, x2, y2, query[, case]
"""
