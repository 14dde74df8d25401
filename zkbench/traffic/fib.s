# fib(n): n from the public input, result to the public output.
# Counterpart of the reference guest `examples/src/bin/fib_input`.
    lw   t0, 0x80(zero)      # public input pointer
    lw   t1, 4(t0)           # n
    addi a0, zero, 0         # fib(0)
    addi a1, zero, 1         # fib(1)
    beq  t1, zero, done
loop:
    add  a2, a0, a1
    mv   a0, a1
    mv   a1, a2
    addi t1, t1, -1
    bne  t1, zero, loop
done:
    lw   t2, 0x84(zero)      # public output pointer
    sw   a0, 0(t2)
    addi a0, zero, 0
    addi a7, zero, 0x201     # Exit
    ecall
