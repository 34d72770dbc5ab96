"""The control plane's audit vocabulary (``control.audit``, a copy), which
the device health ladder records its transitions through."""
