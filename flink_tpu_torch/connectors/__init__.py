"""flink_tpu_torch.connectors"""
