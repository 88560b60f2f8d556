"""flink_tpu_torch.state"""
