"""flink_tpu_torch.graph"""
