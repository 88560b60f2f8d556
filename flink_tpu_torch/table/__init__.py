"""flink_tpu_torch.table"""
