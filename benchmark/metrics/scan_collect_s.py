"""Seconds a sample in the BAM scan and chimera collect: the native record
scan (``io.bam.BamFile``), the CN segments and the diploid coverage
(``Reconstruction.read_cns``) and the chimeric alignments (``.collect``)."""
SPANS = {"scan_collect": [
    "coral_tpu_torch.io.bam:BamFile.__init__",
    "coral_tpu_torch.reconstruct:Reconstruction.read_cns",
    "coral_tpu_torch.reconstruct:Reconstruction.collect"]}


def read(t):
    return t.per_sample("scan_collect")
